"""Batched banded affine-gap extension on device.

The device counterpart of cpu/ksw.py's ``ksw_extend`` (itself the
clean-room equivalent of the ksw.c routine libbwa runs inside
``mem_align1``, bwa.cpp:149). Must agree with the host kernel exactly —
scores, end coordinates, gscore/gtle, and max_off — because CIGAR and
region coordinates downstream depend on them (tests/test_sw_device.py).

Shape strategy (SURVEY.md §7 "irregular control flow"): the DP
runs row-by-row over the target with the query dimension vectorized
across lanes. The F (query-gap) state is a within-row prefix scan; with
the kernel's zero-floor semantics it reduces to a running max of
``t_j + e_ins * j`` (cummax), so each row is pure vector work — no
scalar inner loop. Batches of (query, target) pairs run as lanes of a
``vmap``; rows iterate with ``lax.while_loop`` until every lane has
terminated (Z-drop, zero row, or target exhausted).

The adaptive beg/end band-shrinking of the scalar kernel is replicated
with per-lane scalars + masks so early-terminating semantics (which
affect scores near zero cells) match bit-for-bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bioseqdb_tpu.kernels import dense
from bioseqdb_tpu.kernels.loops import chunked_while

NEG_INF = -(1 << 30)  # plain int, NOT jnp: see kernels/chain.py NEG


@functools.partial(jax.jit, static_argnames=("max_qlen",))
def sw_extend_batch(
    query: jnp.ndarray,      # int32[B, max_qlen] codes 0..4
    qlen: jnp.ndarray,       # int32[B]
    target: jnp.ndarray,     # int32[B, max_tlen] codes 0..4
    tlen: jnp.ndarray,       # int32[B]
    mat: jnp.ndarray,        # int32[5, 5]
    o_del: int | jnp.ndarray,
    e_del: int | jnp.ndarray,
    o_ins: int | jnp.ndarray,
    e_ins: int | jnp.ndarray,
    w0: jnp.ndarray,         # int32[B] band width per lane
    end_bonus: int | jnp.ndarray,
    zdrop: int | jnp.ndarray,
    h0: jnp.ndarray,         # int32[B] initial score per lane
    max_qlen: int,
):
    """Batched ksw_extend. Returns dict of int32[B] arrays:
    score, qle, tle, gtle, gscore, max_off."""
    B = query.shape[0]
    max_tlen = target.shape[1]
    o_del = jnp.int32(o_del)
    e_del = jnp.int32(e_del)
    o_ins = jnp.int32(o_ins)
    e_ins = jnp.int32(e_ins)
    end_bonus = jnp.int32(end_bonus)
    zdrop = jnp.int32(zdrop)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jj = jnp.arange(max_qlen, dtype=jnp.int32)[None, :]  # (1, Q)

    # per-lane band adjustment (ksw_extend's max_ins/max_del clamp)
    max_sc = jnp.max(mat).astype(jnp.int32)
    max_ins = ((qlen * max_sc + end_bonus - o_ins).astype(jnp.float32) / e_ins.astype(jnp.float32) + 1.0).astype(jnp.int32)
    max_del = ((qlen * max_sc + end_bonus - o_del).astype(jnp.float32) / e_del.astype(jnp.float32) + 1.0).astype(jnp.int32)
    w = jnp.minimum(w0, jnp.maximum(max_ins, 1))
    w = jnp.minimum(w, jnp.maximum(max_del, 1))

    # initial H row: h[0] = h0; h[j] = h0 - oe_ins - e_ins*(j-1) while > 0
    h_first = jnp.where(
        jj == 0,
        h0[:, None],
        h0[:, None] - oe_ins - e_ins * (jj - 1),
    )
    # the scalar loop stops propagating at the first value <= e_ins
    # (cells after a non-positive one stay 0)
    h_init = jnp.where(h_first > 0, h_first, 0)
    # also cells beyond qlen are dead
    h_init = jnp.where(jj < qlen[:, None] + 1, h_init, 0)
    e_init = jnp.zeros((B, max_qlen), jnp.int32)

    # query profile (bwa's ksw trick): prof[b, c, j] = mat[c, query[b, j]],
    # built once with dense selects; each row then picks its target-base
    # slice with a 5-way one-hot instead of a per-element mat gather
    rows_sc = []
    for tc in range(5):
        row_sc = jnp.zeros((B, max_qlen), jnp.int32)
        for qc in range(5):
            row_sc = jnp.where(query == qc, mat[tc, qc], row_sc)
        rows_sc.append(row_sc)
    prof = jnp.stack(rows_sc, axis=1)  # (B, 5, Q)

    state = dict(
        h=h_init,                      # H(i-1, j-1) convention: h[j] holds row i-1 value at column j
        e=e_init,                      # E(i, j)
        i=jnp.zeros(B, jnp.int32),     # current row
        beg=jnp.zeros(B, jnp.int32),
        end=qlen.astype(jnp.int32),
        max=h0.astype(jnp.int32),
        max_i=jnp.full(B, -1, jnp.int32),
        max_j=jnp.full(B, -1, jnp.int32),
        max_ie=jnp.full(B, -1, jnp.int32),
        gscore=jnp.full(B, -1, jnp.int32),
        max_off=jnp.zeros(B, jnp.int32),
        active=(tlen > 0) & (qlen > 0),
    )

    def cond(st):
        return jnp.any(st["active"])

    def body(st):
        i = st["i"]
        active = st["active"]
        beg = jnp.maximum(st["beg"], i - w)
        end = jnp.minimum(jnp.minimum(st["end"], i + w + 1), qlen)

        # row target base per lane (dense pick — no per-row gather)
        tbase = dense.pick(target, jnp.minimum(i, max_tlen - 1), axis=1)
        # scores S(i, j) = mat[tbase, query[:, j]] via the query profile
        srow = dense.pick_row(prof, jnp.clip(tbase, 0, 4), axis=1)  # (B, Q)

        in_band = (jj >= beg[:, None]) & (jj < end[:, None])

        # previous-row values at j-1 (the M diagonal) and at j (for E)
        h_prev = st["h"]  # h_prev[j] = H(i-1, j-1) by maintained convention
        e_row = st["e"]

        # h1 at column beg-1: boundary H(i, beg-1)
        h1_bound = jnp.where(
            beg == 0, jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0
        )

        M = jnp.where(h_prev != 0, h_prev + srow, 0)
        M = jnp.where(in_band, M, 0)
        e_cur = jnp.where(in_band, e_row, 0)

        # F via prefix scan: f(beg) = 0; f(j+1) = max(max(M(j)-oe_ins,0), f(j)) - e_ins...
        # scalar kernel: t = max(M(j) - oe_ins, 0); f(j+1) = max(f(j) - e_ins, t)
        # => f(j) = max over j' < j of (t(j') - e_ins*(j-1-j')), floored at
        # intermediate steps (automatic: t >= 0 keeps the running value >= -e_ins)
        # scalar recurrence: f(beg) = 0; f(j) = max(f(j-1) - e_ins, t(j-1))
        # with t >= 0  =>  f(j) = max_{j' <= j-1} (t(j') - e_ins*(j-1-j'))
        # = cummax(t(j') + e_ins*j')[j-1] - e_ins*(j-1), floored at 0 for
        # the row-start boundary.
        t_ins = jnp.maximum(M - oe_ins, 0)
        scan_in = jnp.where(in_band, t_ins + e_ins * jj, NEG_INF)
        run = jax.lax.cummax(scan_in, axis=1)
        g = run - e_ins * jj
        f = jnp.concatenate(
            [jnp.full((B, 1), NEG_INF, jnp.int32), g[:, :-1]], axis=1)
        f = jnp.maximum(f, 0)

        # H(i, j) before considering the H(i, j-1) chain through h1:
        hrow = jnp.maximum(jnp.maximum(M, e_cur), f)
        hrow = jnp.where(in_band, hrow, 0)

        # E(i+1, j)
        t_del = jnp.maximum(M - oe_del, 0)
        e_next = jnp.maximum(e_cur - e_del, t_del)
        e_next = jnp.where(in_band, e_next, 0)

        # row maximum + argmax with the scalar kernel's tie-break
        # (ties take the LARGEST j: m > h ? keep : update)
        hmask = jnp.where(in_band, hrow, -1)
        m_best = jnp.max(hmask, axis=1)
        m_best = jnp.maximum(m_best, 0)
        # last argmax: argmax over reversed
        rev_arg = jnp.argmax(hmask[:, ::-1], axis=1)
        mj = max_qlen - 1 - rev_arg.astype(jnp.int32)
        mj = jnp.where(m_best > 0, mj, -1)

        # h1 at the final column (end) = H(i, end-1): needed for gscore
        h_endm1 = jnp.where(
            end > beg,
            dense.pick(hrow, jnp.maximum(end - 1, 0), axis=1),
            h1_bound,
        )

        # update the rolling h array to hold H(i, j-1):
        # new_h[j] = H(i, j-1) -> shift hrow right by one; column beg gets
        # the boundary h1_bound; else 0 outside
        hrow_shift = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), hrow[:, :-1]], axis=1
        )
        new_h = jnp.where(jj == beg[:, None], h1_bound[:, None], hrow_shift)
        new_h = jnp.where((jj >= beg[:, None]) & (jj <= end[:, None]), new_h, 0)

        # gscore bookkeeping when the band reaches the query end
        reach = end == qlen
        better_g = reach & (st["gscore"] <= h_endm1)
        gscore = jnp.where(active & better_g, h_endm1, st["gscore"])
        max_ie = jnp.where(active & better_g, i, st["max_ie"])

        # termination tests (in the scalar kernel's order)
        break_zero = m_best == 0
        improved = m_best > st["max"]
        new_max = jnp.where(improved, m_best, st["max"])
        new_max_i = jnp.where(improved, i, st["max_i"])
        new_max_j = jnp.where(improved, mj, st["max_j"])
        off = jnp.abs(mj - i)
        new_max_off = jnp.where(improved, jnp.maximum(st["max_off"], off), st["max_off"])
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd1 = st["max"] - m_best - (di - dj) * e_del > zdrop
        zd2 = st["max"] - m_best - (dj - di) * e_ins > zdrop
        break_z = (~improved) & (zdrop > 0) & jnp.where(di > dj, zd1, zd2)

        # band shrink to live cells for the next row. The scalar kernel
        # scans the UPDATED eh[] — h[j] = H(i, j-1) (new_h) and
        # e[j] = E(i+1, j) — over [beg, end] inclusive.
        live = (new_h != 0) | (e_next != 0)
        live &= (jj >= beg[:, None]) & (jj <= end[:, None])
        any_live = jnp.any(live, axis=1)
        first_live = jnp.argmax(live, axis=1).astype(jnp.int32)
        last_live = (
            max_qlen - 1 - jnp.argmax(live[:, ::-1], axis=1).astype(jnp.int32)
        )
        new_beg = jnp.where(any_live, first_live, end)
        new_end = jnp.where(
            any_live,
            jnp.minimum(last_live + 2, qlen),
            jnp.minimum(beg + 1, qlen),
        )

        next_i = i + 1
        terminated = break_zero | break_z | (next_i >= tlen)

        upd = lambda new, old: jnp.where(active[:, None], new, old)
        upds = lambda new, old: jnp.where(active, new, old)
        return dict(
            h=upd(new_h, st["h"]),
            e=upd(e_next, st["e"]),
            i=upds(next_i, st["i"]),
            beg=upds(new_beg, st["beg"]),
            end=upds(new_end, st["end"]),
            max=upds(new_max, st["max"]),
            max_i=upds(new_max_i, st["max_i"]),
            max_j=upds(new_max_j, st["max_j"]),
            max_ie=max_ie,
            gscore=gscore,
            max_off=upds(new_max_off, st["max_off"]),
            active=active & ~terminated,
        )

    st = chunked_while(cond, body, state)
    return dict(
        score=st["max"],
        qle=st["max_j"] + 1,
        tle=st["max_i"] + 1,
        gtle=st["max_ie"] + 1,
        gscore=st["gscore"],
        max_off=st["max_off"],
    )
