"""Full-suite test gate with per-file process isolation.

``python -m pytest tests/`` in ONE process accumulates XLA-CPU compiler
state across ~25 compile-heavy test files and segfaults mid-suite at
~6 GB RSS (reproduced twice in round 2).
Every file passes in isolation, so the gate runs each test file in its
OWN pytest subprocess and aggregates: same coverage, bounded compiler
memory, and a crash in one file cannot take down the rest.

    python tools/run_tests.py [-x] [extra pytest args...]

Exit status is nonzero if any file fails. This is what CI runs
(.github/workflows/ci.yml); `pytest tests/<file>.py` stays the
developer loop for single files.
"""
import glob
import os
import subprocess
import sys
import time


def main() -> int:
    args = sys.argv[1:]
    fail_fast = "-x" in args
    extra = [a for a in args if a != "-x"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(root, "tests", "test_*.py")))
    if not files:
        print("no test files found", file=sys.stderr)
        return 2
    failed = []
    t0 = time.time()
    for f in files:
        name = os.path.basename(f)
        t1 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", f, "-q", *extra], cwd=root)
        dt = time.time() - t1
        status = "ok" if r.returncode == 0 else f"FAIL rc={r.returncode}"
        print(f"[suite] {name:32s} {status:12s} {dt:6.1f}s", flush=True)
        if r.returncode != 0:
            failed.append(name)
            if fail_fast:
                break
    print(f"[suite] {len(files) - len(failed)}/{len(files)} files passed "
          f"in {time.time() - t0:.0f}s"
          + (f"; FAILED: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
