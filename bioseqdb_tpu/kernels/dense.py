"""Dense (one-hot) replacements for tiny-width gather/scatter patterns.

When the indexed axis is small (seed/chain/region slot tables, 4-code
picks, read columns), a masked select + reduction streams at full vector
bandwidth where a gather or scatter would pay per row. The helpers were
chosen on another accelerator, whose gathers and scatters cost per row
regardless of width; their cost on the GPU is not measured (ROADMAP
Speed item 7). These helpers make that substitution uniform.

All helpers preserve dtype and work under vmap/sharding (pure
elementwise + reductions, no gather primitives).
"""

from __future__ import annotations

import jax.numpy as jnp


def _iota(n: int, ndim: int, axis: int):
    """int32 iota of length n placed on ``axis`` of an ndim-broadcast shape."""
    shape = [1] * ndim
    shape[axis] = n
    return jnp.arange(n, dtype=jnp.int32).reshape(shape)


def pick(x: jnp.ndarray, idx: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """x[..., idx, ...] along ``axis`` with a batched index — dense.

    ``idx`` must have the shape of ``x`` with ``axis`` removed. Values of
    ``idx`` outside [0, n) return 0.
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    oh = _iota(n, x.ndim, axis) == jnp.expand_dims(idx, axis)
    return jnp.where(oh, x, 0).sum(axis=axis, dtype=x.dtype)


def pick_row(buf: jnp.ndarray, idx: jnp.ndarray, axis: int = 1) -> jnp.ndarray:
    """Row select buf[b, idx[b], ...] — dense. buf: (B, P, ...), idx: (B,)."""
    n = buf.shape[axis]
    oh = _iota(n, buf.ndim, axis) == idx.reshape(
        idx.shape + (1,) * (buf.ndim - axis)
    )
    return jnp.where(oh, buf, 0).sum(axis=axis, dtype=buf.dtype)


def put_row(buf: jnp.ndarray, idx: jnp.ndarray, val: jnp.ndarray,
            do: jnp.ndarray | None = None, axis: int = 1) -> jnp.ndarray:
    """buf[b, idx[b], ...] = val[b, ...] where ``do`` — dense.

    buf: (B, P, ...); idx, do: (B,); val: buf shape minus ``axis``.
    """
    n = buf.shape[axis]
    oh = _iota(n, buf.ndim, axis) == idx.reshape(
        idx.shape + (1,) * (buf.ndim - axis)
    )
    if do is not None:
        oh = oh & do.reshape(do.shape + (1,) * (buf.ndim - axis))
    return jnp.where(oh, jnp.expand_dims(val, axis), buf)


def reverse_prefix(buf: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """out[b, p] = buf[b, n[b]-1-p] for p < n[b]; rows >= n[b] are zero.

    buf: (B, P, K); n: (B,). Dense (B, P, P) select — P is small.
    """
    B, P = buf.shape[:2]
    p = jnp.arange(P, dtype=jnp.int32)
    src = n[:, None] - 1 - p[None, :]                      # (B, P)
    oh = src[:, :, None] == p[None, None, :]               # (B, Pout, Pin)
    oh = oh & (src >= 0)[:, :, None]
    ohx = oh.reshape(oh.shape + (1,) * (buf.ndim - 2))
    return jnp.where(ohx, buf[:, None], 0).sum(axis=2, dtype=buf.dtype)


def lookup(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[b, ...] = x[b, idx[b, ...]] — dense. x: (B, C) with small C;
    idx: (B, *rest). Out-of-range indices return 0."""
    C = x.shape[1]
    oh = idx[..., None] == jnp.arange(C, dtype=jnp.int32)
    xb = x.reshape(x.shape[:1] + (1,) * (idx.ndim - 1) + (C,))
    return jnp.where(oh, xb, 0).sum(axis=-1, dtype=x.dtype)


def shift_left(x: jnp.ndarray, t: jnp.ndarray, max_shift: int,
               fill=0) -> jnp.ndarray:
    """out[b, j] = x[b, j + t[b]] for j + t[b] < width, else ``fill``.

    Per-lane dynamic shift as a barrel shifter: log2(max_shift) dense
    select steps instead of a per-element gather. ``t`` must be in
    [0, max_shift]."""
    bits = max(1, int(max_shift).bit_length())
    t = t.astype(jnp.int32)
    pad_total = 1 << bits
    W = x.shape[1]
    x = jnp.concatenate(
        [x, jnp.full((x.shape[0], min(pad_total, max_shift)), fill, x.dtype)],
        axis=1,
    )
    for k in range(bits):
        s = 1 << k
        shifted = jnp.concatenate(
            [x[:, s:], jnp.full((x.shape[0], s), fill, x.dtype)], axis=1
        )
        x = jnp.where(((t >> k) & 1 == 1)[:, None], shifted, x)
    return x[:, :W]


def take_rows(buf: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[b, n, ...] = buf[b, idx[b, n], ...] — dense row reorder.
    buf: (B, M, ...); idx: (B, N) with small M. OOB indices read 0."""
    M = buf.shape[1]
    oh = idx[:, :, None] == jnp.arange(M, dtype=jnp.int32)  # (B, N, M)
    ohx = oh.reshape(oh.shape + (1,) * (buf.ndim - 2))
    bufx = buf[:, None]                                     # (B, 1, M, ...)
    return jnp.where(ohx, bufx, 0).sum(axis=2, dtype=buf.dtype)
