"""chip_smoke.py and bench.py outside a GPU, and the compile-cache rule
they share with the CLI (utils/compile_cache.py)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke
from bioseqdb_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("main", [chip_smoke.main, bench.main],
                         ids=["chip_smoke", "bench"])
def test_refuses_a_cpu_device(main, capsys):
    with pytest.raises(SystemExit) as exc:
        main([]) if main is chip_smoke.main else main()
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_in_a_directory(tmp_path):
    """Without the rest of the repo the script exits non-zero and
    prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    info = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=count)
    line = chip_smoke.result_line(info)
    assert "\n" not in line and len(line) < 2000
    assert json.loads(line) == {"ok": True, "device": info}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"NVIDIA H100 80GB HBM3", "count": {count}}}}}')


def test_device_info_names_the_backend():
    assert bench.device_info(jax) == dict(
        platform="cpu", kind=jax.devices()[0].device_kind,
        count=len(jax.devices()))


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and the helper sets no other path;
    without it the cache is <checkout>/.jax_cache."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    sentinel = str(tmp_path / "untouched")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_dir is None:
            monkeypatch.delenv(compile_cache.ENV, raising=False)
            want = os.path.join(REPO, ".jax_cache")
            assert compile_cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv(compile_cache.ENV, path)
            assert compile_cache.enable_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
