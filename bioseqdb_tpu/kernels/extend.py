"""Batched seed-extension orchestration on device.

Device counterpart of the oracle's chain2aln (bwa's mem_chain2aln): per
read, seeds are visited in the exact reference order — kept chains by
descending weight, seeds within a chain by descending score (ties to
the later seed) — and each visited seed is either skipped (contained in
an accumulated region, with the overlap-rescue test) or extended left
and right with the batched banded-SW kernel (kernels/sw_extend.cu on a
GPU, kernels/sw.py on the CPU), including the reference's band-doubling
retry.

The sequential per-read loop is restructured into global *rounds*: in
each round every lane scans forward through its seed order, finalizing
skip decisions (pure vector work), until it finds a seed to extend;
then one batched SW pass serves every active lane. Reads needing more
than ``max_rounds`` extensions overflow to the host oracle (rare for
short reads).

The reference window is never materialized: SW targets gather directly
from the doubled text (pac codes on device), reversed indexing for the
left extension.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

import numpy as np

from bioseqdb_tpu.kernels import dense
from bioseqdb_tpu.kernels import fm as kfm
from bioseqdb_tpu.kernels.loops import chunked_while
from bioseqdb_tpu.kernels.sw import sw_extend_batch

NEG = -(1 << 30)  # plain int: a module-level jnp scalar would be created UNDER
# an active trace when this module is lazily imported inside a jitted
# composition, leaking a tracer into every later trace (buffer-count
# crashes in the jit fastpath)
MAX_BAND_TRY = 2


def sw_kernel_for(platform: str) -> str:
    """The banded-SW kernel for a JAX platform: the CUDA kernel
    (kernels/sw_cuda.py) on a GPU, the XLA kernel (kernels/sw.py, the
    reference) on the CPU. Any other platform has no kernel here."""
    kernels = {"gpu": "cuda", "cpu": "xla"}
    if platform not in kernels:
        raise ValueError(f"no banded-SW kernel for platform {platform!r}")
    return kernels[platform]


ROW_BASES = 2048  # bases per packed-pac row: 128 int32 words. The width
# was chosen for another accelerator's tiled layout and is not measured
# on the GPU (ROADMAP Speed item 7)


def pack_doubled_rows(pac: np.ndarray) -> np.ndarray:
    """Pack the doubled text (forward + reverse-complement) 2-bit,
    16 bases per int32 word (big-endian within the word, matching the
    index packing), ROW_BASES bases per row.

    SW target windows then fetch as a handful of row gathers + dense
    unpacking instead of per-element int8 gathers. The choice was made
    on another accelerator, whose gathers cost per row; it is not
    measured on the GPU.

    Streams in chunks: at GRCh38 scale the naive uint32 materialization
    of the doubled text costs ~37 GB of host temps."""
    pac = np.asarray(pac)
    n_f = len(pac)
    n = 2 * n_f
    nrows = (n + ROW_BASES - 1) // ROW_BASES + 1
    out = np.zeros((nrows, ROW_BASES // 16), np.int32)
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    chunk_rows = max(1, (64 << 20) // ROW_BASES)  # ~64M bases per chunk

    def codes_at(lo, hi):  # doubled-text codes on [lo, hi)
        c = np.empty(hi - lo, np.uint32)
        nf_cut = min(max(n_f - lo, 0), hi - lo)
        if nf_cut > 0:
            c[:nf_cut] = pac[lo : lo + nf_cut]
        if nf_cut < hi - lo:
            rlo, rhi = max(lo, n_f) - n_f, hi - n_f
            c[nf_cut:] = 3 - pac[n_f - 1 - rlo : n_f - 1 - rhi if rhi < n_f
                                 else None : -1]
        return c & 3

    for r0 in range(0, nrows, chunk_rows):
        r1 = min(r0 + chunk_rows, nrows)
        lo, hi = r0 * ROW_BASES, min(r1 * ROW_BASES, n)
        if lo >= n:
            break
        flat = np.zeros((r1 - r0) * ROW_BASES, np.uint32)
        flat[: hi - lo] = codes_at(lo, hi)
        words = (flat.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
        out[r0:r1] = words.view(np.int32).reshape(r1 - r0, ROW_BASES // 16)
    return out


def window_doubled(pw: jnp.ndarray, seq_len, starts: jnp.ndarray, T: int):
    """Codes of the doubled text at [starts, starts+T) per lane;
    out-of-range positions read 4. pw: packed rows (pack_doubled_rows).

    Row gathers + a word-level window shift + dense unpack + a 4-step
    base-level shift — no element gathers. The word window is selected
    BEFORE unpacking: with 2048-base rows, unpacking every gathered
    base first would materialize a (B, NR*2048) int32 intermediate."""
    B = starts.shape[0]
    WPR = pw.shape[1]
    NR = (T + ROW_BASES - 1) // ROW_BASES + 1
    r0 = jnp.floor_divide(starts, ROW_BASES)
    ridx = r0[:, None] + jnp.arange(NR, dtype=r0.dtype)[None, :]
    rows = pw[jnp.clip(ridx, 0, pw.shape[0] - 1)]      # (B, NR, WPR)
    words_all = rows.reshape(B, NR * WPR)
    NW = (T + 15) // 16 + 1
    woff = ((starts - r0 * ROW_BASES) >> 4).astype(jnp.int32)  # word offset
    wwin = dense.shift_left(words_all, woff, WPR)[:, :NW]
    words = jax.lax.bitcast_convert_type(wwin, jnp.uint32)
    shifts = ((15 - jnp.arange(16, dtype=jnp.uint32)) * 2)[None, None, :]
    bases = ((words[:, :, None] >> shifts) & 3).astype(jnp.int32)
    stream = bases.reshape(B, NW * 16)
    win = dense.shift_left(stream, (starts & 15).astype(jnp.int32), 16)[:, :T]
    pos = starts[:, None] + jnp.arange(T, dtype=starts.dtype)[None, :]
    return jnp.where((pos >= 0) & (pos < seq_len), win, 4)


def cal_max_gap(qlen, match_score, o_del, e_del, o_ins, e_ins, bandwidth):
    l_del = ((qlen * match_score - o_del).astype(jnp.float32) / e_del + 1.0).astype(jnp.int32)
    l_ins = ((qlen * match_score - o_ins).astype(jnp.float32) / e_ins + 1.0).astype(jnp.int32)
    return jnp.minimum(jnp.maximum(jnp.maximum(l_del, l_ins), 1), bandwidth << 1)


def fetch_doubled(pac_dev, l_pac, seq_len, positions, axis=None):
    """Gather codes from the doubled text; out-of-range -> 4. With
    ``axis``, pac_dev holds this shard's position range and results are
    psum'd to the owner (kernels/fm.py sharding convention)."""
    inb = (positions >= 0) & (positions < seq_len)
    p = jnp.clip(positions, 0, seq_len - 1)
    fwd = p < l_pac
    idx = jnp.where(fwd, p, seq_len - 1 - p)
    if axis is None:
        base = pac_dev[idx].astype(jnp.int32)
    else:
        per = pac_dev.shape[0]
        start = jax.lax.axis_index(axis).astype(jnp.int32) * per
        local = idx - start
        mine = (local >= 0) & (local < per)
        base = jnp.where(mine, pac_dev[jnp.clip(local, 0, per - 1)].astype(jnp.int32), 0)
        base = jax.lax.psum(base, axis)
    val = jnp.where(fwd, base, 3 - base)
    return jnp.where(inb, val, 4)


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_rounds", "max_regs", "max_qlen", "max_tlen",
        "match_score", "mismatch_penalty", "o_del", "e_del", "o_ins", "e_ins",
        "bandwidth", "zdrop", "pen_clip5", "pen_clip3", "shard_axis",
        "sw_kernel", "sw_sort", "sw_mesh",
    ),
)
def extend_all(
    fm: kfm.FMDevice,
    pac_dev: jnp.ndarray,     # int8[l_pac] forward codes on device
    codes: jnp.ndarray,       # int32[B, W] read codes
    lens: jnp.ndarray,        # int32[B]
    seeds: dict,              # from resolve_seeds
    chains: dict,             # from chain_seeds
    flt: dict,                # from filter_chains
    mat: jnp.ndarray,         # int32[5,5]
    match_score: int, mismatch_penalty: int,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    bandwidth: int, zdrop: int, pen_clip5: int, pen_clip3: int,
    max_rounds: int = 6,
    max_regs: int = 8,
    max_qlen: int = 0,
    max_tlen: int = 0,
    shard_axis: str | None = None,
    sw_kernel: str = "xla",
    sw_sort: bool | None = None,
    sw_mesh=None,
):
    """Run the extension stage. Returns per-read region table:
    rb/re/qb/qe/score/truesc/w/seedlen0 int32[B, R] + n_regs + overflow.
    seedcov is filled per region; frac_rep is the caller's concern.

    ``sw_kernel`` names the banded-SW kernel (``sw_kernel_for``);
    ``sw_sort`` orders lanes by expected DP rows around each SW call
    (default: exactly for the CUDA kernel, whose lanes exit one by one);
    ``sw_mesh``, a mesh with a ``data`` axis over which the batch is
    sharded, runs each SW call per shard under ``shard_map``.
    """
    if sw_sort is None:
        sw_sort = sw_kernel == "cuda"
    B, S = seeds["rbeg"].shape
    C = chains["pos"].shape[1]
    R = max_regs
    i32 = jnp.int32
    rdt = seeds["rbeg"].dtype  # rank dtype (int64 for >2^31 indexes)
    rows = jnp.arange(B)
    if max_qlen <= 0:
        max_qlen = int(codes.shape[1])
    if max_tlen <= 0:
        # a reference window spans at most the read plus the band-bounded
        # gap allowance on both sides (cal_max_gap caps at 2*bandwidth)
        max_tlen = int(codes.shape[1]) + 4 * bandwidth + 64
    # 2-D pac = packed doubled rows (pack_doubled_rows; row-gather fetch);
    # 1-D pac = forward int8 codes (element fetch — the sharded path)
    pac_packed = pac_dev.ndim == 2 and shard_axis is None

    # ---- the global seed processing order -------------------------------
    ci = chains["assign"]                     # (B, S); -1/-2 = not in a chain
    in_chain = ci >= 0
    cis = jnp.clip(ci, 0, C - 1)
    crank = dense.lookup(
        jnp.argsort(flt["order"], axis=1).astype(i32), cis
    )                                         # weight rank of the seed's chain
    ckept = dense.lookup(flt["kept"], cis) > 0
    usable = in_chain & ckept & seeds["valid"]
    slen = seeds["len"]
    # order key: chain rank asc, then score desc with ties to later slot.
    # Seed score = len * match unless the long-read seed-SW filter
    # (kernels/seedsw.py) re-scored it (bwa s->score semantics).
    sscore = seeds.get("score")
    if sscore is None:
        sscore = slen * match_score
    sidx = jnp.arange(S, dtype=i32)[None, :]
    key = (crank * (1 << 19)
           + (4095 - jnp.clip(sscore, 0, 4095)) * (1 << 7)
           + (S - 1 - sidx))
    key = jnp.where(usable, key, jnp.int32(0x7FFFFFF0))
    order = jnp.argsort(key, axis=1).astype(i32)   # (B, S) slot processing order
    n_usable = usable.sum(axis=1).astype(i32)

    # ---- per-chain rmax windows ----------------------------------------
    qlen_rem = lens[:, None] - seeds["qbeg"] - slen
    gap_l = cal_max_gap(seeds["qbeg"], match_score, o_del, e_del, o_ins, e_ins, bandwidth)
    gap_r = cal_max_gap(qlen_rem, match_score, o_del, e_del, o_ins, e_ins, bandwidth)
    b_all = seeds["rbeg"] - (seeds["qbeg"] + gap_l)
    e_all = seeds["rbeg"] + slen + qlen_rem + gap_r
    big = jnp.asarray(jnp.iinfo(rdt).max // 2, rdt)
    rmax0 = jnp.full((B, C), big, rdt)
    rmax1 = jnp.zeros((B, C), rdt)

    def rbody(s, state):
        rmax0, rmax1 = state
        isin = in_chain[:, s]
        c = cis[:, s]
        cur0 = dense.pick_row(rmax0, c)
        cur1 = dense.pick_row(rmax1, c)
        rmax0 = dense.put_row(
            rmax0, c, jnp.minimum(cur0, b_all[:, s].astype(rdt)), isin
        )
        rmax1 = dense.put_row(
            rmax1, c, jnp.maximum(cur1, e_all[:, s].astype(rdt)), isin
        )
        return rmax0, rmax1

    rmax0, rmax1 = jax.lax.fori_loop(0, S, rbody, (rmax0, rmax1))
    rmax0 = jnp.maximum(rmax0, 0)
    rmax1 = jnp.minimum(rmax1, fm.seq_len)
    # crossing the strand boundary: clip to the side of the first seed
    cfirst = chains["f_rbeg"]
    crosses = (rmax0 < fm.l_pac) & (fm.l_pac < rmax1)
    rmax1 = jnp.where(crosses & (cfirst < fm.l_pac), fm.l_pac, rmax1)
    rmax0 = jnp.where(crosses & (cfirst >= fm.l_pac), fm.l_pac, rmax0)
    # clip to the reference containing the first seed (bns_fetch_seq):
    # extensions must not cross concatenated reference boundaries
    crid = jnp.clip(chains["rid"], 0, fm.ref_offsets.shape[0] - 1)
    roff = kfm._small_rows(fm.ref_offsets, crid)
    rlen_ref = kfm._small_rows(fm.ref_lens, crid)
    mid_rev = cfirst >= fm.l_pac
    far_beg = jnp.where(mid_rev, fm.seq_len - (roff + rlen_ref), roff)
    far_end = jnp.where(mid_rev, fm.seq_len - roff, roff + rlen_ref)
    rmax0 = jnp.maximum(rmax0, far_beg)
    rmax1 = jnp.minimum(rmax1, far_end)

    # ---- extension rounds ----------------------------------------------
    regs = dict(
        rb=jnp.zeros((B, R), rdt), re=jnp.zeros((B, R), rdt),
        qb=jnp.zeros((B, R), i32), qe=jnp.zeros((B, R), i32),
        score=jnp.zeros((B, R), i32), truesc=jnp.zeros((B, R), i32),
        w=jnp.zeros((B, R), i32), seedlen0=jnp.zeros((B, R), i32),
        cchain=jnp.full((B, R), -1, i32),
        rid=jnp.full((B, R), -1, i32),
    )
    n_regs = jnp.zeros(B, i32)
    cursor = jnp.zeros(B, i32)            # index into `order`
    was_ext = jnp.zeros((B, S), jnp.bool_)
    overflow = jnp.zeros(B, jnp.bool_)

    W = codes.shape[1]
    wcols = jnp.arange(max_qlen, dtype=i32)[None, :]
    tcols = jnp.arange(max_tlen, dtype=i32)[None, :]

    def containment_scan(cursor, n_regs, regs, was_ext):
        """Advance each lane's cursor over seeds whose decision is final
        (skip), returning the slot to extend (or S = none)."""

        def scan_body(state):
            cursor, decided = state
            slot = dense.pick_row(order, jnp.clip(cursor, 0, S - 1))
            active = (cursor < n_usable) & ~decided
            sq = dense.pick_row(seeds["qbeg"], slot)
            sr = dense.pick_row(seeds["rbeg"], slot)
            sl = dense.pick_row(slen, slot)
            # covered-by-region test (vector over R)
            rr = jnp.arange(R, dtype=i32)[None, :]
            has = rr < n_regs[:, None]
            inside = (
                has
                & (sr[:, None] >= regs["rb"]) & (sr[:, None] + sl[:, None] <= regs["re"])
                & (sq[:, None] >= regs["qb"]) & (sq[:, None] + sl[:, None] <= regs["qe"])
                & ((sl[:, None] - regs["seedlen0"]) <= (lens[:, None] // 10))
            )
            qd = sq[:, None] - regs["qb"]
            rd = sr[:, None] - regs["rb"]
            mg = cal_max_gap(jnp.minimum(qd, rd), match_score, o_del, e_del,
                             o_ins, e_ins, bandwidth)
            wlim = jnp.minimum(mg, regs["w"])
            near1 = ((qd - rd) < wlim) & ((rd - qd) < wlim)
            qd2 = regs["qe"] - (sq[:, None] + sl[:, None])
            rd2 = regs["re"] - (sr[:, None] + sl[:, None])
            mg2 = cal_max_gap(jnp.minimum(qd2, rd2), match_score, o_del, e_del,
                              o_ins, e_ins, bandwidth)
            wlim2 = jnp.minimum(mg2, regs["w"])
            near2 = ((qd2 - rd2) < wlim2) & ((rd2 - qd2) < wlim2)
            covered = jnp.any(inside & (near1 | near2), axis=1)
            # overlap rescue: an already-extended same-chain seed of
            # similar length on a different diagonal
            samechain = cis == dense.pick_row(cis, slot)[:, None]
            cand = was_ext & samechain & seeds["valid"]
            t_q = seeds["qbeg"]
            t_r = seeds["rbeg"]
            t_l = slen
            c1 = (
                (sq[:, None] <= t_q)
                & ((sq[:, None] + sl[:, None] - t_q) >= (sl[:, None] >> 2))
                & ((t_q - sq[:, None]) != (t_r - sr[:, None]))
            )
            c2 = (
                (t_q <= sq[:, None])
                & ((t_q + t_l - sq[:, None]) >= (sl[:, None] >> 2))
                & ((sq[:, None] - t_q) != (sr[:, None] - t_r))
            )
            simlen = t_l >= (sl[:, None] * 19 + 19) // 20  # t.len >= s.len*0.95
            need = jnp.any(cand & simlen & (c1 | c2), axis=1)
            skip = active & covered & ~need
            cursor = jnp.where(skip, cursor + 1, cursor)
            decided = decided | (active & ~skip) | (cursor >= n_usable)
            return cursor, decided

        def scan_cond(state):
            _, decided = state
            return jnp.any(~decided)

        cursor, _ = chunked_while(
            scan_cond, scan_body, (cursor, jnp.zeros(B, jnp.bool_)), chunk=8
        )
        slot = dense.pick_row(order, jnp.clip(cursor, 0, S - 1))
        todo = cursor < n_usable
        return cursor, slot, todo

    def sw_one(qbuf, qn, tbuf, tn, w, bonus, h0):
        if sw_kernel == "cuda":
            from bioseqdb_tpu.kernels.sw_cuda import sw_extend_batch_cuda

            return sw_extend_batch_cuda(
                qbuf, qn, tbuf, tn, w, h0,
                match_score=match_score, mismatch_penalty=mismatch_penalty,
                o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                end_bonus=bonus, zdrop=zdrop)
        return sw_extend_batch(qbuf, qn, tbuf, tn, mat, o_del, e_del,
                               o_ins, e_ins, w, bonus, zdrop, h0, max_qlen)

    def sw_with_retry_local(qbuf, qn_a, tbuf, tn, h0, prev_sc, active,
                            bonus):
        """One ksw_extend with the reference's MAX_BAND_TRY band doubling:
        retry at twice the band iff the try-1 score differs from the
        pre-extension score AND the max diagonal offset filled the band.

        With ``sw_sort`` the lanes are sorted by expected DP row count
        before the kernel runs and unpermuted after; results are
        identical. The CUDA kernel's lanes exit one by one, so a sorted
        batch lets a warp's lanes finish together, and the sparse active
        lanes of later rounds pack into a few warps."""
        n = qbuf.shape[0]
        w1 = jnp.full(n, bandwidth, i32)
        if sw_sort:
            # row count until the band empties ~ min(tlen, qlen + band);
            # idle lanes sort last so their warps exit at once
            work = jnp.where(qn_a > 0, jnp.minimum(tn, qn_a + bandwidth), -1)
            perm = jnp.argsort(-work).astype(i32)
            srt = lambda x: jnp.take(x, perm, axis=0)
            qbuf, qn_a, tbuf, tn, h0, prev_sc, active = (
                srt(qbuf), srt(qn_a), srt(tbuf), srt(tn), srt(h0),
                srt(prev_sc), srt(active))
        r1 = sw_one(qbuf, qn_a, tbuf, tn, w1, bonus, h0)
        retry = (
            active
            & (r1["score"] != prev_sc)
            & (r1["max_off"] >= ((w1 >> 1) + (w1 >> 2)))
        )
        qn_b = jnp.where(retry, qn_a, 0)
        w2 = w1 * 2
        # retries are rare (band-filling diagonal offsets): skip the
        # whole second SW launch at runtime when no lane retries
        r2 = jax.lax.cond(
            jnp.any(retry),
            lambda: sw_one(qbuf, qn_b, tbuf, tn, w2, bonus, h0),
            lambda: {k: jnp.zeros_like(v) for k, v in r1.items()},
        )
        # the reference keeps the wider-band results whenever it retried
        out = {k: jnp.where(retry, r2[k], r1[k]) for k in r1}
        out["aw"] = jnp.where(retry, w2, w1)
        if sw_sort:
            inv = jnp.zeros(n, i32).at[perm].set(jnp.arange(n, dtype=i32))
            out = {k: jnp.take(v, inv, axis=0) for k, v in out.items()}
        return out

    def sw_with_retry(qbuf, qn, tbuf, tn, h0, bonus, active, prev_sc):
        qn_a = jnp.where(active, qn, 0)
        run = functools.partial(sw_with_retry_local, bonus=bonus)
        if sw_mesh is not None:
            from jax.sharding import PartitionSpec as P

            run = jax.shard_map(run, mesh=sw_mesh, in_specs=P("data"),
                                out_specs=P("data"), check_vma=False)
        out = run(qbuf, qn_a, tbuf, tn, h0, prev_sc, active)
        aw = out.pop("aw")
        return out, aw

    def round_body(_, carry):
        regs, n_regs, cursor, was_ext, overflow = carry
        cursor, slot, todo = containment_scan(cursor, n_regs, regs, was_ext)
        ovf_now = todo & (n_regs >= R)
        overflow = overflow | ovf_now
        act = todo & ~ovf_now

        # after the first 1-2 rounds most batches have ZERO active lanes
        # left (short reads mostly extend once) — but the SW launches
        # still cost real time per round (launch overhead plus whole
        # warps kept alive by a stray lane). Runtime-skip the
        # entire extension body when nothing is active; only the scan
        # above is semantically needed every round.
        def ext_body(carry2):
            regs, n_regs, cursor, was_ext = carry2
            return _extend_round(regs, n_regs, cursor, was_ext, act, slot)

        def ext_skip(carry2):
            return carry2

        regs, n_regs, cursor, was_ext = jax.lax.cond(
            jnp.any(act), ext_body, ext_skip, (regs, n_regs, cursor, was_ext)
        )
        return regs, n_regs, cursor, was_ext, overflow

    def _extend_round(regs, n_regs, cursor, was_ext, act, slot):
        sq = dense.pick_row(seeds["qbeg"], slot)
        sr = dense.pick_row(seeds["rbeg"], slot)
        sl = dense.pick_row(slen, slot)
        c = dense.pick_row(cis, slot)
        r0 = dense.pick_row(rmax0, c)
        r1_ = dense.pick_row(rmax1, c)

        # ---- left extension ----
        lq = sq                            # length of reversed query prefix
        lt = (sr - r0).astype(i32)         # length of reversed target prefix
        # reversed query prefix via flip + barrel shift (no gathers):
        # qbuf_l[j] = codes[sq-1-j] = flip(codes)[W-sq+j]
        qbuf_l = dense.shift_left(
            codes[:, ::-1], (W - sq).astype(i32), W, fill=4
        )[:, :max_qlen]
        qbuf_l = jnp.where(wcols < lq[:, None], qbuf_l, 4)
        if pac_packed:
            winl = window_doubled(pac_dev, fm.seq_len, sr - max_tlen, max_tlen)
            traw_l = winl[:, ::-1]
        else:
            tpos = sr[:, None] - 1 - tcols
            traw_l = fetch_doubled(pac_dev, fm.l_pac, fm.seq_len, tpos, shard_axis)
        tbuf_l = jnp.where(tcols < lt[:, None], traw_l, 4)
        has_l = act & (lq > 0)
        resL, awL = sw_with_retry(
            qbuf_l, lq, tbuf_l, jnp.where(has_l, lt, 0),
            (sl * match_score).astype(i32), pen_clip5, has_l,
            jnp.full(B, -1, i32),
        )
        local_l = (resL["gscore"] <= 0) | (resL["gscore"] <= resL["score"] - pen_clip5)
        qb = jnp.where(has_l, jnp.where(local_l, sq - resL["qle"], 0), 0)
        rb = jnp.where(
            has_l,
            jnp.where(local_l, sr - resL["tle"], sr - resL["gtle"]),
            sr,
        )
        score_l = jnp.where(has_l, resL["score"], sl * match_score)
        truesc_l = jnp.where(
            has_l, jnp.where(local_l, resL["score"], resL["gscore"]),
            sl * match_score,
        )

        # ---- right extension ----
        qe0 = sq + sl
        rq = lens - qe0
        re0 = sr + sl
        rt = (r1_ - re0).astype(i32)
        qbuf_r = dense.shift_left(codes, qe0, W, fill=4)[:, :max_qlen]
        qbuf_r = jnp.where(wcols < rq[:, None], qbuf_r, 4)
        if pac_packed:
            traw_r = window_doubled(pac_dev, fm.seq_len, re0, max_tlen)
        else:
            tpos_r = re0[:, None] + tcols
            traw_r = fetch_doubled(pac_dev, fm.l_pac, fm.seq_len, tpos_r, shard_axis)
        tbuf_r = jnp.where(tcols < rt[:, None], traw_r, 4)
        has_r = act & (rq > 0)
        resR, awR = sw_with_retry(
            qbuf_r, rq, tbuf_r, jnp.where(has_r, rt, 0),
            score_l, pen_clip3, has_r, score_l,
        )
        local_r = (resR["gscore"] <= 0) | (resR["gscore"] <= resR["score"] - pen_clip3)
        qe = jnp.where(has_r, jnp.where(local_r, qe0 + resR["qle"], lens), qe0)
        re = jnp.where(
            has_r, jnp.where(local_r, re0 + resR["tle"], re0 + resR["gtle"]), re0
        )
        score = jnp.where(has_r, resR["score"], score_l)
        truesc = truesc_l + jnp.where(
            has_r,
            jnp.where(local_r, resR["score"] - score_l, resR["gscore"] - score_l),
            0,
        )
        aw = jnp.maximum(jnp.where(has_l, awL, bandwidth),
                         jnp.where(has_r, awR, bandwidth))

        # append region
        slot_r = jnp.minimum(n_regs, R - 1)

        def put(name, value):
            return dense.put_row(regs[name], slot_r, value, act)

        regs = dict(regs)
        regs["rb"] = put("rb", rb.astype(rdt))
        regs["re"] = put("re", re.astype(rdt))
        regs["qb"] = put("qb", qb)
        regs["qe"] = put("qe", qe)
        regs["score"] = put("score", score)
        regs["truesc"] = put("truesc", truesc)
        regs["w"] = put("w", aw)
        regs["seedlen0"] = put("seedlen0", sl)
        regs["cchain"] = put("cchain", c)
        regs["rid"] = put("rid", dense.pick_row(chains["rid"], c))
        n_regs = n_regs + act.astype(i32)
        was_ext = dense.put_row(
            was_ext, slot, jnp.ones(B, jnp.bool_), act
        )
        cursor = jnp.where(act, cursor + 1, cursor)
        return regs, n_regs, cursor, was_ext

    regs, n_regs, cursor, was_ext, overflow = jax.lax.fori_loop(
        0, max_rounds, round_body, (regs, n_regs, cursor, was_ext, overflow)
    )
    # any lane with seeds still pending after max_rounds overflows
    overflow = overflow | (cursor < n_usable)

    # seedcov per region: seeds of the same chain fully inside the region
    seedcov = jnp.zeros((B, R), i32)

    def cov_body(s, seedcov):
        sq = seeds["qbeg"][:, s][:, None]
        sr = seeds["rbeg"][:, s][:, None]
        sl_ = slen[:, s][:, None]
        # the reference sums only seeds of the region's own chain
        okc = (seeds["valid"][:, s] & in_chain[:, s])[:, None] & (
            cis[:, s][:, None] == regs["cchain"]
        )
        inside = (
            okc
            & (sq >= regs["qb"]) & (sq + sl_ <= regs["qe"])
            & (sr >= regs["rb"]) & (sr + sl_ <= regs["re"])
        )
        return seedcov + jnp.where(inside, sl_, 0)

    seedcov = jax.lax.fori_loop(0, S, cov_body, seedcov)
    regs = dict(regs)
    regs["seedcov"] = seedcov
    return dict(regs=regs, n_regs=n_regs, overflow=overflow)
