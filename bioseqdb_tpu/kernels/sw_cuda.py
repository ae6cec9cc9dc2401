"""The banded-SW extension kernel for NVIDIA GPUs (kernels/sw_extend.cu).

Same contract as kernels/sw.py:sw_extend_batch, which stays the
semantic reference and the CPU path; the results are equal field for
field. The wrapper maps the operands onto the kernel's layouts (codes as
uint8, lane-minor) and casts every integer operand to int32, so the call
is the same under jax x64.

The CUDA source compiles with ``nvcc`` on first use into
``kernels/_build/`` (git-ignored), keyed by a hash of the source and the
JAX FFI headers; ``python -m bioseqdb_tpu.kernels.sw_cuda`` builds it
ahead of time. A failed build raises: there is no fallback to the XLA
kernel on a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sw_extend.cu")
_BUILD = os.path.join(_DIR, "_build")
TARGET = "bst_sw_extend"
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (PATH or {CUDA_HOME}/bin): the GPU extension "
            "kernel cannot be built")
    return path


def build_command(out_path: str) -> list[str]:
    """The nvcc command line that builds the kernel library."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out_path, _SRC,
    ]


def library_path() -> str:
    """Build (if needed) and return the path of the kernel library."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(jax.ffi.include_dir().encode())
    path = os.path.join(_BUILD, f"libsw_extend.{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {_SRC} (exit {res.returncode}):\n"
            f"{res.stderr[-4000:]}")
    os.replace(tmp, path)  # atomic under concurrent builders
    return path


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(library_path())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.BstSwExtend), platform="CUDA")


def to_kernel_layout(query, qlen, target, tlen, w0, h0):
    """The kernel's operands: query codes outside 0..4 become 5 (scores
    0, as in the XLA kernel's query profile), target codes clip to 0..4
    (as its row pick does), both transposed lane-minor as uint8; the
    per-lane vectors become int32."""
    i32 = lambda x: jnp.asarray(x).astype(jnp.int32)
    q = i32(query)
    q = jnp.where((q >= 0) & (q <= 4), q, 5).astype(jnp.uint8).T
    t = jnp.clip(i32(target), 0, 4).astype(jnp.uint8).T
    return q, i32(qlen), t, i32(tlen), i32(w0), i32(h0)


@functools.partial(
    jax.jit,
    static_argnames=("match_score", "mismatch_penalty", "o_del", "e_del",
                     "o_ins", "e_ins", "end_bonus", "zdrop"))
def sw_extend_batch_cuda(query, qlen, target, tlen, w0, h0, *,
                         match_score: int, mismatch_penalty: int,
                         o_del: int, e_del: int, o_ins: int, e_ins: int,
                         end_bonus: int, zdrop: int):
    """Batched ksw_extend on the GPU, scored by the bwa 5x5 matrix of
    (match_score, mismatch_penalty). Arguments as sw_extend_batch, with
    max_qlen = query.shape[1]; requires qlen <= max_qlen and
    tlen <= target.shape[1]. Returns the same dict of int32[B] arrays."""
    from bioseqdb_tpu.cpu.ksw import fill_scmat

    _register()
    q, qlen, t, tlen, w0, h0 = to_kernel_layout(query, qlen, target, tlen,
                                                w0, h0)
    Q, B = q.shape
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((6, B), jnp.int32),
         jax.ShapeDtypeStruct((Q + 2, B, 2), jnp.int32)),
    )(q, qlen, t, tlen, w0, h0,
      mat=np.asarray(fill_scmat(match_score, mismatch_penalty),
                     np.int32).reshape(-1),
      o_del=np.int32(o_del), e_del=np.int32(e_del), o_ins=np.int32(o_ins),
      e_ins=np.int32(e_ins), end_bonus=np.int32(end_bonus),
      zdrop=np.int32(zdrop))
    return dict(score=out[0], qle=out[1], tle=out[2], gtle=out[3],
                gscore=out[4], max_off=out[5])


if __name__ == "__main__":
    print(library_path())
