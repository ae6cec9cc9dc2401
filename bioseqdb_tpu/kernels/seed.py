"""Batched SMEM seeding on device.

The device counterpart of the oracle's three seeding rounds
(cpu/oracle.py collect_intv == bwa's mem_collect_intv feeding
mem_align1, reference bwa.cpp:149). Each read is a lane running a small
state machine (pivot selection / forward pass / backward pass / re-seed
/ LAST-like pass); every global iteration performs exactly one batched
FMD extension — two occ4 row gathers across all lanes — so the
irregular per-read control flow costs control-overhead only, while the
memory traffic stays perfectly batched (SURVEY.md §7).

The loop carries reads as PACKED STREAMS rather than the (B, W) int32
codes array, whose dense one-hot column picks dominated the loop body
on the accelerator this was first built for (not measured on the GPU):
``cpk`` (16 2-bit codes per int32 word,
big-endian), ``abm`` (ambiguity bitmap, 1 bit/code) and ``jcw`` (r3
jump-window-clean bitmap) — a column read is a ~16x narrower word pick
plus shifts, and the r3 jump key is reassembled from two adjacent words
(funnel shift + 2-bit reversal) instead of a precomputed (B, W) table.

An in-loop s==1 fast-forward (six extra phases riding the shared
gather) was measured slower in every configuration on the accelerator
this was first built for, and was deleted. The unified-table builder
(build_seed_table) carries only the r3 prefix-jump rows.

State sizes are compile-time caps tuned for short reads (<= ~300 bp):
``P`` candidate intervals per pass and ``M`` output seeds per read; the
``overflow`` output flags any read that exceeded them (callers fall
back to the host oracle for those — none in practice for 151 bp reads).

Must agree exactly with the oracle's collect_intv (tests/test_seed_device.py).
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp

from bioseqdb_tpu.kernels import fm as kfm
from bioseqdb_tpu.kernels import dense

# phases
PH_PIVOT = 0   # choose the next pivot / round transition
PH_FWD = 1     # forward pass of smem1
PH_BWD = 2     # backward pass of smem1
PH_R3 = 3      # bwt_seed_strategy1 forward scan
PH_DONE = 4
PH_R3J = 5     # round-3 jump pending: fetch the depth-J prefix interval

N_PHASES = 6

JUMP_DEPTH = 8  # r3 jump table depth (4^J keys)

# rounds
RD_SMEM = 0    # round 1: SMEMs
RD_RESEED = 1  # round 2: re-seed long low-occ SMEMs
RD_LAST = 2    # round 3: LAST-like seeds

DEBUG_CENSUS = False  # tools/iter_split.py: per-phase iteration counters


@functools.partial(jax.jit, static_argnames=("depth",))
def _r3_jump_rows(fm: kfm.FMDevice, depth: int = JUMP_DEPTH) -> jnp.ndarray:
    """Bi-intervals of every length-``depth`` pattern, encoded as
    synthetic Occ-block rows (int32[2*4^depth, 12]).

    Appended after the real blocks (build_seed_table), key ``key``'s
    interval is recovered through the seeding loop's ONE shared fused
    gather: a rank query at block ``base + 2*key`` offset 0 returns the
    row's checkpoint columns verbatim (in-block count 0; the appended
    zero major-checkpoint row contributes 0), so fmd_extend_back's
    ``k4 - (L2+1)`` IS row A and ``s4`` IS row B - row A. Ranks are
    30-bit lo/hi split so the scheme survives int64 (>2^31) indexes
    whose values don't fit the int32 block table."""
    K = 4 ** depth
    keys = jnp.arange(K, dtype=jnp.int32)
    c0 = keys & 3
    k = fm.L2[c0] + 1
    l = fm.L2[3 - c0] + 1
    s = fm.L2[c0 + 1] - fm.L2[c0]

    def step(t, kls):
        k, l, s = kls
        ct = ((keys >> (2 * t)) & 3).astype(jnp.int32)
        k4, l4, s4 = kfm.fmd_extend_fwd(fm, k, l, s)
        take = lambda m: jnp.take_along_axis(m, ct[:, None], axis=1)[:, 0]
        return take(k4), take(l4), take(s4)

    k, l, s = jax.lax.fori_loop(1, depth, step, (k, l, s))
    lo = lambda v: (v & 0x3FFFFFFF).astype(jnp.int32)
    hi = lambda v: (v >> 30).astype(jnp.int32)
    zeros = jnp.zeros((K, 8), jnp.int32)
    row_a = jnp.concatenate(
        [jnp.stack([lo(k), hi(k), lo(l), hi(l)], axis=1), zeros], axis=1)
    row_b = jnp.concatenate(
        [jnp.stack([lo(k) + lo(s), hi(k) + hi(s), lo(l), hi(l)], axis=1),
         zeros], axis=1)
    return jnp.stack([row_a, row_b], axis=1).reshape(2 * K, 12)


# Table size below which the r3 jump rows are appended: the 20 MB value
# is the fast gather tier of another accelerator, where the choice was
# made; the GPU's tiers (a 50 MB L2) are not measured here (ROADMAP
# Speed item 7).
_FAST_TIER_BYTES = int(20 * (1 << 20))


def _pick_jump_depth(n_blocks: int, base: int) -> int:
    """Largest jump depth whose table extension stays under the gather
    fast tier (any depth is free once the table is already past it)."""
    if n_blocks * 48 >= _FAST_TIER_BYTES:
        return JUMP_DEPTH
    for d in (JUMP_DEPTH, 6):
        if (base + 2 * (4 ** d)) * 48 <= _FAST_TIER_BYTES:
            return d
    return 0


def _pack_jump_oct(rows: jnp.ndarray) -> jnp.ndarray:
    """(2K, 12) synthetic block rows -> (2K/8, 128) octo rows (mark
    columns zero: jump rows are never LF-stepped)."""
    K2 = rows.shape[0]
    r96 = rows.reshape(K2 // kfm.OCT_BLOCKS, 12 * kfm.OCT_BLOCKS)
    return jnp.concatenate(
        [r96, jnp.zeros((r96.shape[0], kfm.OCT_COLS - 96), jnp.int32)],
        axis=1)


def build_r3_jump(fm: kfm.FMDevice, depth: int | None = None,
                  host_blocks=None, host_sa_bits=None,
                  host_splice_threshold: int = 1 << 30,
                  ) -> tuple[kfm.FMDevice, int, int]:
    """Extend an FMDevice with the r3 jump table; returns
    (fm', base, depth).

    ``base`` is the first synthetic block row (64-aligned so extended
    rows resolve to the appended all-zero major checkpoint); 0 means the
    jump is disabled (rank range exhausted, or the extension would push
    a fast-tier table over the gather cliff). ``depth`` None picks the
    largest profitable depth for the table size.

    ``host_blocks`` (the numpy blocks table, e.g. ``idx.blocks``) lets
    multi-GB indexes splice the jump rows on HOST: the device
    concatenate transiently multiplies the table allocation, which ran a
    16 GB device out of memory at GRCh38 scale. ``host_sa_bits`` must ride along there so
    the spliced table keeps its in-row SA-mark words (pack_oct)."""
    import numpy as np

    n_blocks = fm.n_block_rows  # octo layout: blocks.shape[0] * 8
    base = -(-n_blocks // kfm.MAJOR_BLOCKS) * kfm.MAJOR_BLOCKS
    if depth is None:
        depth = _pick_jump_depth(n_blocks, base)
        if depth == 0:
            return fm, 0, 0
    K = 4 ** depth
    max_rank = (base + 2 * K) * kfm.OCC_BLOCK + 2
    if fm.rank_dtype == jnp.int32 and max_rank >= 2**31:
        return fm, 0, 0
    rows = _r3_jump_rows(fm, depth)  # (2K, 12) block rows; 2K % 8 == 0
    rows_oct = _pack_jump_oct(rows)
    majors_ext = jnp.concatenate(
        [fm.occ_majors, jnp.zeros((1, 4), fm.occ_majors.dtype)], axis=0)
    if host_blocks is not None and fm.blocks.nbytes > host_splice_threshold:
        # preserve the ORIGINAL placement (mesh-replicated tables must
        # stay replicated — the round-3 build_seed_table lesson)
        place = getattr(fm.blocks, "sharding", None)
        if place is None:
            place = next(iter(fm.blocks.devices()), None)
        ext = np.zeros((base + 2 * K, 12), np.int32)
        ext[: host_blocks.shape[0]] = host_blocks
        ext[base:] = np.asarray(jax.device_get(rows))
        blocks_ext = jax.device_put(
            jnp.asarray(kfm.pack_oct(ext, host_sa_bits)), place)
    else:
        pad = jnp.zeros(((base - n_blocks) // kfm.OCT_BLOCKS, kfm.OCT_COLS),
                        jnp.int32)
        blocks_ext = jnp.concatenate([fm.blocks, pad, rows_oct], axis=0)
    return fm._replace(blocks=blocks_ext, occ_majors=majors_ext), base, depth


class SeedTable(typing.NamedTuple):
    """Static (hashable) map of the seeding table extension: the r3
    prefix-jump rows appended to ``fm.blocks`` (build_seed_table), whose
    lookups ride the loop's single fused row gather with zero extra
    gather ops. ``jump_base`` is in BLOCK units; 0 disables the jump."""

    jump_base: int = 0
    jump_depth: int = 0


def build_seed_table(fm: kfm.FMDevice, idx, depth: int | None = None
                     ) -> tuple[kfm.FMDevice, SeedTable]:
    """Assemble the seeding table: the Occ octo rows plus the r3 jump
    rows (build_r3_jump). Multi-GB indexes splice on host (one
    device_put) — device concatenates transiently double the allocation,
    which ran a 16 GB device out of memory at GRCh38 scale.

    ``idx`` is the host FMIndex. ``depth`` None auto-picks the jump
    depth (build_r3_jump rules); 0 disables the jump."""
    import numpy as np

    fm2, base, jd = build_r3_jump(
        fm, depth=depth, host_blocks=np.asarray(idx.blocks),
        host_sa_bits=np.ascontiguousarray(np.asarray(idx.sa_bits)))
    return fm2, SeedTable(jump_base=base if jd > 0 else 0, jump_depth=jd)


def _rev2(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit groups within each uint32 word."""
    v = v.astype(jnp.uint32)
    m1, m2, m3 = jnp.uint32(0x33333333), jnp.uint32(0x0F0F0F0F), jnp.uint32(0x00FF00FF)
    v = ((v >> jnp.uint32(2)) & m1) | ((v & m1) << jnp.uint32(2))
    v = ((v >> jnp.uint32(4)) & m2) | ((v & m2) << jnp.uint32(4))
    v = ((v >> jnp.uint32(8)) & m3) | ((v & m3) << jnp.uint32(8))
    return (v >> jnp.uint32(16)) | (v << jnp.uint32(16))


def _pack_streams(codes: jnp.ndarray, jump_depth: int):
    """Pack (B, W) int32 codes into the loop's read streams:

    - ``cpk`` int32[B, W/16 + 1]: 16 2-bit codes per word, code p at
      bits 2*(15 - (p & 15)) of word p >> 4 (big-endian; ambiguous
      codes stored as 0 — their value is never read). One zero pad word
      lets the r3 key window read word d+1 unconditionally.
    - ``abm`` int32[B, W/32]: ambiguity bitmap, bit (p & 31) of word
      p >> 5 set iff codes[p] >= 4.
    - ``jcw`` int32[B, W/32] (or None when no jump): bit p set iff the
      depth-J window codes[p .. p+J-1] is all valid (reads padded with
      ambiguity beyond W, matching the old jpack precompute).
    """
    B, W = codes.shape
    NW = -(-W // 16)
    NB = -(-W // 32)
    u32 = jnp.uint32
    i32 = lambda u: jax.lax.bitcast_convert_type(u, jnp.int32)

    cpad = jnp.pad(codes, ((0, 0), (0, NW * 16 - W)), constant_values=4)
    grp = cpad.reshape(B, NW, 16)
    sh2 = (2 * (15 - jnp.arange(16, dtype=u32)))[None, None, :]
    cw = (jnp.where(grp < 4, grp, 0).astype(u32) << sh2).sum(axis=2, dtype=u32)
    cpk = jnp.concatenate([i32(cw), jnp.zeros((B, 1), jnp.int32)], axis=1)

    amb = jnp.pad(codes >= 4, ((0, 0), (0, NB * 32 - W)),
                  constant_values=True)
    aw = (amb.reshape(B, NB, 32).astype(u32)
          << jnp.arange(32, dtype=u32)[None, None, :]).sum(axis=2, dtype=u32)
    abm = i32(aw)

    jcw = None
    if jump_depth > 0:
        cpadJ = jnp.pad(codes, ((0, 0), (0, jump_depth)), constant_values=4)
        clean = jnp.ones((B, W), jnp.bool_)
        for t in range(jump_depth):
            clean = clean & (cpadJ[:, t : t + W] < 4)
        cl = jnp.pad(clean, ((0, 0), (0, NB * 32 - W)), constant_values=False)
        jw = (cl.reshape(B, NB, 32).astype(u32)
              << jnp.arange(32, dtype=u32)[None, None, :]).sum(
                  axis=2, dtype=u32)
        jcw = i32(jw)
    return cpk, abm, jcw


@functools.partial(
    jax.jit,
    static_argnames=("min_seed_len", "split_width", "max_mem_intv", "split_len",
                     "max_cand", "max_mem", "max_iters", "shard_axis",
                     "jump_base", "jump_depth", "sa_interval", "kcand",
                     "share_fetch", "entry_reseed"),
)
def collect_seeds_device(
    fm: kfm.FMDevice,
    codes: jnp.ndarray,   # int32[B, W] 0..3 bases, >=4 ambiguous/padding
    lens: jnp.ndarray,    # int32[B]
    min_seed_len: int,
    split_len: int,
    split_width: int,
    max_mem_intv: int,
    max_cand: int = 24,
    max_mem: int = 48,
    max_iters: int = 0,
    shard_axis: str | None = None,
    jump_base: int = 0,
    jump_depth: int = JUMP_DEPTH,
    sa_interval: int = 32,
    kcand: int = 1,
    quad_rows: jnp.ndarray | None = None,
    share_fetch: bool = True,
    entry_reseed: bool = False,
    reseed_entry: dict | None = None,
):
    """Run all three seeding rounds for a batch of reads.

    ``max_iters`` (0 = 10*W + 256) caps per-lane state-machine steps:
    pathological repeat-heavy lanes otherwise stretch the whole batch's
    while_loop tail (every lane pays for the slowest). Capped lanes set
    ``overflow`` and fall back to the host oracle.

    ``jump_base`` > 0 enables the round-3 depth-J jump: the fm must be
    build_r3_jump/build_seed_table-extended, and each bwt_seed_strategy1
    scan then starts at depth J via one prefix-table fetch instead of J
    stepwise extensions (exact-equivalent: stops before depth
    min_seed_len are impossible, so the skipped states are unobservable).
    The per-pivot jump key is reassembled in-loop from the packed code
    stream (two word picks + a funnel shift + 2-bit reversal) — the old
    precomputed (B, W) jpack table was one of the dominant per-step
    pick scans (round-4 cost split).

    Reads ride in the state as packed streams (_pack_streams): every
    column read is a word pick over ~W/16 int32s instead of a one-hot
    scan over W int32s. The dense (B, W) picks were 65.9% of the
    estimated full-width body cycles at B=16K (round 4,
    tools/seed_cost_split.py).

    Returns dict with
      mems:  int32[B, max_mem, 5] — (k, l, s, start, end) per seed
      n_mem: int32[B]
      overflow: bool[B] — caps exceeded (fall back to host)
    """
    B, W = codes.shape
    P, M = max_cand, max_mem
    i32 = jnp.int32
    rdt = fm.seq_len.dtype  # rank dtype (int64 for >2^31 indexes)
    default_budget = max_iters <= 0
    if default_budget:
        max_iters = 10 * W + 256
    J = jump_depth
    # stepwise r3 cannot stop before depth min_seed_len, so the jump is
    # only exact-equivalent when it skips strictly shorter depths
    jump = jump_base > 0 and J > 0 and min_seed_len >= J and W > J
    # multi-candidate backward columns: KC candidates per iteration
    # (in-row decodes are unsharded; sharded rank math would need a psum
    # per candidate)
    KC = kcand if (shard_axis is None and kcand > 0) else 1
    # quad-row fetch (kfm.quad_table): 48-int32 rows, 4-way pick. The
    # KC>1 covering-pair decode needs full octo rows; quad implies KC=1.
    if quad_rows is not None:
        KC = 1
    # fetch sharing: 74.6% of live iterations have both rank positions
    # (a, a+s) inside ONE octo row (1024 bases; an iteration census),
    # and the shared gather was per-ROW bound on the accelerator this
    # was designed for (not measured on the GPU). So fetch ONE row per lane
    # and decode both occ4 offsets from it; the ~25% split lanes stall
    # one iteration (pend2) to fetch the second row, with the first
    # decode held in o1hold. Exact: stalled lanes freeze their state,
    # so the re-derived (a, s) and decodes are identical.
    share = (share_fetch and shard_axis is None and KC == 1
             and quad_rows is None)
    if share and default_budget:
        # ~25% of consuming iterations become split-pair stalls under
        # fetch sharing (census), so the default per-lane budget —
        # calibrated for stall-free trips — scales up ~4/3; an explicit
        # caller cap (fat retry, A/B tools) is left untouched
        max_iters = (40 * W + 1024) // 3

    cpk, abm, jcw = _pack_streams(codes.astype(i32), J if jump else 0)

    st = dict(
        phase=jnp.zeros(B, i32),
        round=jnp.zeros(B, i32),
        x=jnp.zeros(B, i32),                      # pivot
        i=jnp.zeros(B, i32),                      # scan position
        ik=jnp.zeros((B, 3), rdt),                # current bi-interval
        ik_end=jnp.zeros(B, i32),
        # candidate tables carry (k, s, end) — the l half of the
        # bi-interval is dead once a pass turns backward (backward
        # extension's k/s updates never read l, fm.fmd_extend_from_occ,
        # and mems' l column is unread downstream), and dropping it cuts
        # the loop's dominant HBM cost: the state tables are rewritten
        # every iteration.
        cand=jnp.zeros((B, P, 3), rdt),           # (k, s, end)
        n_cand=jnp.zeros(B, i32),
        prev=jnp.zeros((B, P, 3), rdt),
        n_prev=jnp.zeros(B, i32),
        curr=jnp.zeros((B, P, 3), rdt),
        n_curr=jnp.zeros(B, i32),
        j=jnp.zeros(B, i32),                      # index into prev
        ret=jnp.zeros(B, i32),                    # next pivot after smem1
        rev1=jnp.zeros(B, jnp.bool_),             # first bwd column reads
                                                  # prev (=cand) in reverse
        min_intv=jnp.ones(B, rdt),                # per-lane (round 2 overrides)
        # in-loop mems are FOUR (B, M) COLUMN arrays (k, s, start, end):
        # a (B, M, 4) table tempted XLA, on the accelerator this was
        # first built for, into a layout whose 4-wide minor dim padded
        # to 128 lanes, and the per-iteration put_row fusion then
        # materialized 32x the logical bytes. The dead l column is
        # re-added to the 5-wide output layout only at return.
        mem_k=jnp.zeros((B, M), rdt),
        mem_s=jnp.zeros((B, M), rdt),
        mem_b=jnp.zeros((B, M), rdt),
        mem_e=jnp.zeros((B, M), rdt),
        # fetch-sharing scratch: split-pair stall flag + held first decode
        **(dict(pend2=jnp.zeros(B, jnp.bool_),
                o1hold=jnp.zeros((B, 4), rdt)) if share else {}),
        n_mem=jnp.zeros(B, i32),
        n_mem_r1=jnp.zeros(B, i32),               # count after round 1
        r2i=jnp.zeros(B, i32),                    # round-2 source mem index
        last_start=jnp.full(B, W + 1, i32),       # containment check state
        iters=jnp.zeros(B, i32),
        it_r1=jnp.zeros(B, i32),                  # iters when round 1 ended
        it_r2=jnp.zeros(B, i32),                  # iters when round 2 ended
        overflow=jnp.zeros(B, jnp.bool_),
        # per-lane inputs live in the state so straggler compaction can
        # gather a lane's whole context in one tree_map
        cpk=cpk,
        abm=abm,
        lens=lens,
    )
    if jump:
        st["jcw"] = jcw
        st["jkey_pend"] = jnp.zeros(B, i32)  # key latched at pivot time
    if DEBUG_CENSUS:
        st["ph_census"] = jnp.zeros((B, N_PHASES), i32)
        st["bwd_dead"] = jnp.zeros(B, i32)
        st["bwd_np1"] = jnp.zeros(B, i32)
        st["bwd_cols"] = jnp.zeros(B, i32)
        st["sr_same"] = jnp.zeros(B, i32)  # fetch pair in one octo row
    # lanes with no bases never run
    st["phase"] = jnp.where(lens > 0, PH_PIVOT, PH_DONE)

    if entry_reseed:
        # Reseed-only entry (the kmer seeder's round-2 leg,
        # kernels/kmer.py): rounds 1 and 3 were computed elsewhere;
        # preload their mems (s/b/e; k is never read by round 2) and
        # start the machine directly in RD_RESEED. Callers pass
        # max_mem_intv=0 so the machine ends after round 2. The
        # dependent trip is the reseed pivots' alone (~tens of steps
        # on the rare lanes that need it, vs ~600 for a full trip).
        pre = reseed_entry
        M0 = pre["mem_s"].shape[1]
        npad = ((0, 0), (0, M - M0))
        ld = lambda a: jnp.pad(a.astype(rdt), npad)
        st["mem_s"] = ld(pre["mem_s"])
        st["mem_b"] = ld(pre["mem_b"])
        st["mem_e"] = ld(pre["mem_e"])
        st["n_mem"] = pre["n_mem"].astype(i32)
        st["n_mem_r1"] = pre["n_mem"].astype(i32)
        st["round"] = jnp.full(B, RD_RESEED, i32)
        st["phase"] = jnp.where(pre["active"] & (lens > 0),
                                PH_PIVOT, PH_DONE)

    u32 = jnp.uint32
    as_u32 = lambda w: jax.lax.bitcast_convert_type(w, u32)

    def qat_in(stt, pos):
        """Read code at per-lane column ``pos``: 0..3 = base, 4..7 =
        ambiguous (original >=4 codes collapse to one class — every
        consumer only tests ``q >= 4`` or uses ``q`` masked to valid).
        Word picks over the packed streams; see module docstring."""
        p = jnp.clip(pos, 0, W - 1)
        w = as_u32(dense.pick(stt["cpk"], p >> 4, axis=1))
        a = as_u32(dense.pick(stt["abm"], p >> 5, axis=1))
        c2 = ((w >> (2 * (15 - (p & 15))).astype(u32)) & 3).astype(i32)
        ambb = ((a >> (p & 31).astype(u32)) & 1).astype(i32)
        return c2 | (ambb << 2)

    def jkey_at(stt, x):
        """r3 jump key at pivot ``x``: codes x..x+J-1 packed little-
        endian 2-bit (key = sum_t q[x+t] << 2t), or -1 when the window
        contains an ambiguous base (jcw bit clear). Reassembled from
        two adjacent cpk words — exact equal to the old jpack table."""
        p = jnp.clip(x, 0, W - 1)
        w0 = as_u32(dense.pick(stt["cpk"], p >> 4, axis=1))
        w1 = as_u32(dense.pick(stt["cpk"], (p >> 4) + 1, axis=1))
        r2b = (2 * (p & 15)).astype(u32)
        # clamp the dead-branch shift below 32 (undefined in XLA)
        rs = jnp.minimum(u32(32) - r2b, u32(31))
        hi = jnp.where(r2b > 0, w1 >> rs, u32(0))
        u = jnp.where(r2b > 0, (w0 << r2b) | hi, w0)
        key = (_rev2(u) & u32((1 << (2 * J)) - 1)).astype(i32)
        jb = as_u32(dense.pick(stt["jcw"], p >> 5, axis=1))
        clean = ((jb >> (p & 31).astype(u32)) & 1) == 1
        return jnp.where(clean, key, -1)

    def set_intv(c):
        c = jnp.clip(c, 0, 3)
        k = kfm._lut(fm.L2, c) + 1
        l = kfm._lut(fm.L2, 3 - c) + 1
        s = kfm._lut(fm.L2, c + 1) - kfm._lut(fm.L2, c)
        return jnp.stack([k, l, s], axis=-1).astype(rdt)

    def push_row(buf, n, row, do):
        """Append `row` to per-lane buffer where `do`; returns new buf, n, ovf.

        One-hot write — no scatter."""
        cap = buf.shape[1]
        ovf = do & (n >= cap)
        write = do & ~ovf
        buf = dense.put_row(buf, jnp.minimum(n, cap - 1), row, write)
        n = n + write.astype(i32)
        return buf, n, ovf

    def pivot_step(st):
        """Pivot/bookkeeping transitions, applied BEFORE the shared
        gather (transition-fused state machine): a lane that picks a new
        pivot runs its first extension in the same global iteration
        instead of burning a whole gather slot on bookkeeping. Pure
        vector work — this is the exact PH_PIVOT logic that used to run
        (equally unconditionally) after the gather, so fusing it is
        free; only multi-step chains (ambiguous pivot chars, ineligible
        round-2 sources) still take an iteration per step."""
        st = dict(st)
        phase = st["phase"]
        rnd = st["round"]
        L = st["lens"]
        x = st["x"]
        qx = qat_in(st, x)
        at_pivot = phase == PH_PIVOT
        # round transitions when the scan is exhausted
        r1_done = at_pivot & (rnd == RD_SMEM) & (x >= L)
        to_r2 = r1_done
        rnd = jnp.where(to_r2, RD_RESEED, rnd)
        st["n_mem_r1"] = jnp.where(to_r2, st["n_mem"], st["n_mem_r1"])
        r2i = jnp.where(to_r2, 0, st["r2i"])
        st["it_r1"] = jnp.where(to_r2, st["iters"], st["it_r1"])

        # round 2 iterates over round-1 mems (column picks: (B, M) one-
        # hots, no narrow-minor-dim table materialization)
        at_r2 = at_pivot & (rnd == RD_RESEED)
        r2ix = jnp.clip(r2i, 0, M - 1)
        r2_s = dense.pick_row(st["mem_s"], r2ix)
        r2_b = dense.pick_row(st["mem_b"], r2ix)
        r2_e = dense.pick_row(st["mem_e"], r2ix)
        r2_len = (r2_e - r2_b).astype(i32)
        r2_eligible = (r2_len >= split_len) & (r2_s <= split_width)
        r2_exhausted = at_r2 & (r2i >= st["n_mem_r1"])
        r2_skip = at_r2 & ~r2_exhausted & ~r2_eligible
        r2_go = at_r2 & ~r2_exhausted & r2_eligible
        r2i = jnp.where(r2_skip, r2i + 1, r2i)

        # round 3 start
        to_r3 = r2_exhausted
        rnd = jnp.where(to_r3, RD_LAST, rnd)
        st["round"] = rnd
        x = jnp.where(to_r3, 0, x)
        st["it_r2"] = jnp.where(to_r3, st["iters"], st["it_r2"])
        at_r3p = at_pivot & (rnd == RD_LAST)
        r3_off = at_r3p & ((max_mem_intv <= 0) | (x >= L))
        st["phase"] = jnp.where(r3_off, PH_DONE, st["phase"])

        # round-1 pivot handling
        p1 = at_pivot & (rnd == RD_SMEM) & (x < L)
        amb1 = p1 & (qx >= 4)
        x = jnp.where(amb1, x + 1, x)
        go1 = p1 & (qx < 4)
        # round-2 pivot: x = (start+end)>>1, min_intv = s+1
        go2 = r2_go
        piv2 = ((r2_b + r2_e) >> 1).astype(i32)
        x = jnp.where(go2, piv2, x)
        st["min_intv"] = jnp.where(
            go2, r2_s + 1, jnp.where(go1, 1, st["min_intv"]))
        go = go1 | go2
        qpiv = qat_in(st, x)
        piv_amb2 = go2 & (qpiv >= 4)  # re-seed pivot on an N: skip it
        r2i = jnp.where(piv_amb2, r2i + 1, r2i)
        go = go & ~piv_amb2
        st["ik"] = jnp.where(go[:, None], set_intv(qpiv), st["ik"])
        st["ik_end"] = jnp.where(go, x + 1, st["ik_end"])
        st["i"] = jnp.where(go, x + 1, st["i"])
        st["n_cand"] = jnp.where(go, 0, st["n_cand"])
        st["phase"] = jnp.where(go, PH_FWD, st["phase"])

        # round-3 pivot handling (one pick: go3 lanes leave x unchanged,
        # so the post-advance code equals the ambiguity-check code)
        p3 = at_r3p & ~r3_off & (max_mem_intv > 0)
        q3 = qat_in(st, x)
        amb3 = p3 & (q3 >= 4)
        x = jnp.where(amb3, x + 1, x)
        go3 = p3 & ~amb3
        if jump:
            # start at depth J via the prefix table when the window is
            # clean and inside the read (PH_R3J redirects this step's
            # gather at it)
            jk3 = jkey_at(st, x)
            jump3 = go3 & (jk3 >= 0) & (x + J <= L)
            go3 = go3 & ~jump3
            st["phase"] = jnp.where(jump3, PH_R3J, st["phase"])
            st["jkey_pend"] = jnp.where(jump3, jnp.maximum(jk3, 0),
                                        st["jkey_pend"])
        st["ik"] = jnp.where(go3[:, None], set_intv(q3), st["ik"])
        st["i"] = jnp.where(go3, x + 1, st["i"])
        st["phase"] = jnp.where(go3, PH_R3, st["phase"])
        st["x"] = x
        st["r2i"] = r2i
        return st

    def body(st):
        # per-lane step budget: cap pathological lanes (overflow -> host)
        over_budget = (st["phase"] != PH_DONE) & (st["iters"] >= max_iters)
        st = dict(st)
        st["overflow"] = st["overflow"] | over_budget
        st["phase"] = jnp.where(over_budget, PH_DONE, st["phase"])
        st["iters"] = st["iters"] + (st["phase"] != PH_DONE).astype(i32)

        st = pivot_step(st)

        if "ph_census" in st:  # debug instrumentation (tools/iter_split.py)
            oh = jax.nn.one_hot(st["phase"], N_PHASES, dtype=i32)
            st["ph_census"] = st["ph_census"] + oh
            st["bwd_dead"] = st["bwd_dead"] + (
                (st["phase"] == PH_BWD)
                & ((st["i"] < 0) | (qat_in(st, st["i"]) >= 4))
            ).astype(i32)
            inb = st["phase"] == PH_BWD
            st["bwd_np1"] = st["bwd_np1"] + (
                inb & (st["n_prev"] == 1)).astype(i32)
            st["bwd_cols"] = st["bwd_cols"] + (inb & (st["j"] == 0)).astype(i32)

        phase = st["phase"]
        rnd = st["round"]
        lens = st["lens"]
        L = lens
        x, i, j = st["x"], st["i"], st["j"]
        qi = qat_in(st, i)
        in_fwd = phase == PH_FWD
        in_bwd = phase == PH_BWD
        in_r3 = phase == PH_R3
        nB = phase.shape[0]  # local width (compaction narrows the state)

        # ---- the one batched FMD extension everybody shares ----
        # forward lanes extend st.ik (or r3 ik) forward by q[i];
        # backward lanes extend prev[j] backward by q[i] (prev is stored
        # longest-first: reversed once at the fwd->bwd transition)
        # the first backward column must visit candidates longest-first
        # (bwt_reverse_intvs); instead of materializing a reversed copy
        # of `cand` (a (B,P,P) one-hot every iteration), read prev in
        # reverse index order while `rev1` is set
        j_eff = jnp.where(st["rev1"], st["n_prev"] - 1 - j, j)
        bwd_iv = dense.pick_row(st["prev"], jnp.clip(j_eff, 0, P - 1))  # (B, 3)
        if KC > 1:
            # ---- multi-candidate backward columns ----
            # A column's candidates are NESTED intervals (they share the
            # start bw_i+1, so shorter patterns have superset intervals;
            # visit order is longest-first = ascending interval size).
            # The (j+KC-1)-th visited candidate therefore COVERS the next
            # KC: when its interval spans <= 2 octo rows, this
            # iteration's shared gather (its two rows) contains every
            # occ position of all KC candidates — decode them all and
            # process the whole group in one iteration (the backward
            # pass is ~50% of all iterations, ~6 candidates per column).
            cov_v = jnp.minimum(j + (KC - 1), st["n_prev"] - 1)
            cov_st = jnp.where(st["rev1"], st["n_prev"] - 1 - cov_v, cov_v)
            cov_iv = dense.pick_row(st["prev"], jnp.clip(cov_st, 0, P - 1))
            ck = cov_iv[:, 0]
            cs = jnp.maximum(cov_iv[:, 1], 0)
            jA = ck - (ck > fm.primary).astype(rdt)
            ce = ck + cs
            jB = ce - (ce > fm.primary).astype(rdt)
            multi = (
                in_bwd & (i >= 0) & (qi < 4)
                & (((jB >> 10) - (jA >> 10)) <= 1) & (cov_v > j)
            )
            src_k = jnp.where(
                in_bwd, jnp.where(multi, ck, bwd_iv[:, 0]), st["ik"][:, 0])
            src_s = jnp.where(
                in_bwd, jnp.where(multi, cs, bwd_iv[:, 1]), st["ik"][:, 2])
        else:
            multi = jnp.zeros_like(in_bwd)
            src_k = jnp.where(in_bwd, bwd_iv[:, 0], st["ik"][:, 0])
            src_s = jnp.where(in_bwd, bwd_iv[:, 1], st["ik"][:, 2])
        # backward lanes have no live l (dropped column): 0 feeds the
        # dead l4 side only
        src_l = jnp.where(in_bwd, 0, st["ik"][:, 1])
        # unify: fwd == back on the (l, k) swap + code flip
        a = jnp.where(in_bwd, src_k, src_l)
        b = jnp.where(in_bwd, src_l, src_k)
        s_eff = jnp.maximum(src_s, 0)
        if jump:
            # r3-jump lanes redirect their two gather slots at the prefix
            # table: rank A hits synthetic block base+2*key at offset 0,
            # A + 128 the next row (_r3_jump_rows layout)
            in_r3j = phase == PH_R3J
            A = ((jnp.asarray(jump_base, rdt) + 2 * st["jkey_pend"])
                 * kfm.OCC_BLOCK + 1).astype(rdt)
            a = jnp.where(in_r3j, A, a)
            s_eff = jnp.where(in_r3j, kfm.OCC_BLOCK, s_eff)
        else:
            in_r3j = jnp.zeros_like(in_fwd)

        if "sr_same" in st:
            # would the (a, a+s) fetch pair share one octo row? (the
            # fetch-sharing lever: rows are the gather's cost unit)
            jA_ = a - (a > fm.primary).astype(rdt)
            jB_ = (a + s_eff) - ((a + s_eff) > fm.primary).astype(rdt)
            live_ = st["phase"] != PH_DONE
            st["sr_same"] = st["sr_same"] + (
                live_ & ((jA_ >> 10) == (jB_ >> 10))).astype(i32)

        if share:
            # ---- shared single-row fetch (see the `share` note) ----
            pend = st["pend2"]
            jA = a - (a > fm.primary).astype(rdt)
            posB = a + s_eff
            jB = posB - (posB > fm.primary).astype(rdt)
            same = (jA >> 10) == (jB >> 10)
            qi_ok = qi < 4
            # lanes that actually consume this step's extension result;
            # non-consuming transitions (end-of-read, ambiguity, dead
            # columns) never read occ4 and must not stall
            consume = ((in_fwd & (i < L) & qi_ok)
                       | (in_bwd & (i >= 0) & qi_ok)
                       | (in_r3 & (i < L) & qi_ok))
            stall = consume & ~same & ~pend
            fetch_r = jnp.where(pend, posB, a)
            rows1, blk1, off1, mine1 = kfm.occ_rows_for(fm, fetch_r, None)
            oF = kfm.occ4_from_quad(fm, rows1, blk1, off1, mine1)
            blkB = (jB >> kfm._LOG2_OCC_BLOCK)
            offB = (jB & (kfm.OCC_BLOCK - 1)).astype(i32)
            # second decode from the SAME fetched row (valid when the
            # pair shares the octo row; garbage otherwise — masked by
            # the stall gating below). r3-jump pairs are always
            # same-row: blkA = base + 2*key is even, blkB = blkA + 1.
            oS = kfm.occ4_from_quad(fm, rows1, blkB, offB, mine1)
            o1 = jnp.where(pend[:, None], st["o1hold"], oF)
            o2 = jnp.where(pend[:, None], oF, oS)
            # stalled lanes apply nothing this iteration (state frozen;
            # the second row arrives next step)
            in_fwd = in_fwd & ~stall
            in_bwd = in_bwd & ~stall
            in_r3 = in_r3 & ~stall
        else:
            # rows-based fused extension (bit-identical to
            # fmd_extend_back): the raw octo rows stay available for
            # the multi-candidate decodes
            both = jnp.concatenate([a, a + s_eff])
            if quad_rows is not None:
                rows2, blk2, off2, mine2 = kfm.occ_rows_for_q(
                    fm, quad_rows, both, shard_axis)
                occ4b, _rows12 = kfm.occ4_and_block_q(
                    fm, rows2, blk2, off2, mine2, shard_axis)
            else:
                rows2, blk2, off2, mine2 = kfm.occ_rows_for(fm, both,
                                                            shard_axis)
                occ4b, _rows12 = kfm.occ4_and_block(fm, rows2, blk2, off2,
                                                    mine2, shard_axis)
            o1, o2 = occ4b[:nB], occ4b[nB:]
            rowsA, blkA, offA = rows2[:nB], blk2[:nB], off2[:nB]
        k4, l4, s4 = kfm.fmd_extend_from_occ(fm, a, b, s_eff, o1, o2)

        c_raw = qi
        c_ext = jnp.where(in_bwd, c_raw, 3 - c_raw)
        c_sel = jnp.clip(c_ext, 0, 3)
        ok_k = dense.pick(jnp.where(in_bwd[:, None], k4, l4), c_sel, axis=1)
        ok_l = dense.pick(jnp.where(in_bwd[:, None], l4, k4), c_sel, axis=1)
        ok_s = dense.pick(s4, c_sel, axis=1)

        if KC > 1:
            # single-code extensions of the earlier-visited (longer,
            # nested) candidates, decoded from the two fetched covering
            # rows — no extra gather rows
            rowsB = rows2[nB:]
            octA = (blkA >> 3)
            L2c = kfm._lut(fm.L2, c_sel)
            sub_k, sub_s, sub_iv = [], [], []
            for t in range(KC - 1):
                vt = j + t
                stx = jnp.where(st["rev1"], st["n_prev"] - 1 - vt, vt)
                civ = dense.pick_row(st["prev"], jnp.clip(stx, 0, P - 1))
                pk = civ[:, 0]
                ps = jnp.maximum(civ[:, 1], 0)
                o1c = kfm.occ_c_from_pair(fm, rowsA, rowsB, octA, c_sel, pk)
                o2c = kfm.occ_c_from_pair(fm, rowsA, rowsB, octA, c_sel,
                                          pk + ps)
                sub_k.append(L2c + 1 + o1c)
                sub_s.append(o2c - o1c)
                sub_iv.append(civ)

        new = dict(st)
        if share:
            new["pend2"] = stall
            new["o1hold"] = jnp.where(stall[:, None], oF, st["o1hold"])

        # ============== PH_R3J: decode the prefix row ==============
        if jump:
            # fmd_extend_back returns row A as k4 - (L2+1) and
            # row B - row A as s4; 30-bit lo/hi words reassemble ranks
            o1j = k4 - (fm.L2[:4] + 1)
            k8 = o1j[:, 0] + (o1j[:, 1] << 30)
            l8 = o1j[:, 2] + (o1j[:, 3] << 30)
            s8 = s4[:, 0].astype(rdt) + (s4[:, 1].astype(rdt) << 30)
            new["ik"] = jnp.where(
                in_r3j[:, None], jnp.stack([k8, l8, s8], axis=1), new["ik"]
            )
            new["i"] = jnp.where(in_r3j, x + J, new["i"])
            new["phase"] = jnp.where(in_r3j, PH_R3, new["phase"])

        # ============== PH_FWD ==============
        # (uses this step's extension result)
        fwd_end_of_read = in_fwd & (i >= L)
        fwd_amb = in_fwd & (i < L) & (qi >= 4)
        fwd_ext = in_fwd & (i < L) & (qi < 4)
        ik_row = jnp.stack(
            [st["ik"][:, 0], st["ik"][:, 2], st["ik_end"].astype(rdt)],
            axis=1)
        # push current ik when: end-of-read, ambiguous, or size change
        size_change = fwd_ext & (ok_s != st["ik"][:, 2])
        push_fwd = fwd_end_of_read | fwd_amb | size_change
        new["cand"], new["n_cand"], ovf1 = push_row(
            new["cand"], new["n_cand"], ik_row, push_fwd
        )
        new["overflow"] = st["overflow"] | ovf1
        drop_below = size_change & (ok_s < st["min_intv"])
        adv = fwd_ext & ~drop_below
        new["ik"] = jnp.where(
            adv[:, None], jnp.stack([ok_k, ok_l, ok_s], axis=1), new["ik"]
        )
        new["ik_end"] = jnp.where(adv, i + 1, new["ik_end"])
        new["i"] = jnp.where(adv, i + 1, new["i"])
        fwd_done = fwd_end_of_read | fwd_amb | drop_below
        # transition to backward pass: prev := cand, visited in reverse
        # (longest candidate first, bwt_reverse_intvs) via the rev1 flag
        new["prev"] = jnp.where(fwd_done[:, None, None], new["cand"], st["prev"])
        new["n_prev"] = jnp.where(fwd_done, new["n_cand"], st["n_prev"])
        new["rev1"] = jnp.where(fwd_done, True, st["rev1"])
        # ret (next round-1 pivot) = end of the longest candidate = last pushed
        lastc = jnp.clip(new["n_cand"] - 1, 0, P - 1)
        new["ret"] = jnp.where(
            fwd_done, dense.pick_row(new["cand"][:, :, 2], lastc).astype(i32),
            st["ret"],
        )
        new["i"] = jnp.where(fwd_done, x - 1, new["i"])
        new["j"] = jnp.where(fwd_done, 0, st["j"])
        new["n_curr"] = jnp.where(fwd_done, 0, st["n_curr"])
        new["last_start"] = jnp.where(fwd_done, W + 1, st["last_start"])
        new["phase"] = jnp.where(fwd_done, PH_BWD, new["phase"])

        # ============== PH_BWD ==============
        # Processes up to KC candidates of the column per iteration (one
        # batched extension for the covering candidate + in-row decodes
        # for the rest); the fold below replays the per-candidate
        # sequential semantics (emit gating, distinct-size pushes) as
        # pure vector work. KC == 1 degenerates to the classic
        # one-candidate-per-iteration form.
        bw_i = i  # current backward position (may be -1)
        c_ok = in_bwd & (bw_i >= 0) & (qi < 4)  # qi == qat(bw_i) here
        if KC > 1:
            n_proc = jnp.where(multi, cov_v - j + 1, 1)
            main_iv = jnp.where(multi[:, None], cov_iv, bwd_iv)
        else:
            n_proc = jnp.ones_like(j)
            main_iv = bwd_iv
        n_curr_r = st["n_curr"]
        lastq = jnp.clip(n_curr_r - 1, 0, P - 1)
        last_s_r = dense.pick_row(st["curr"][:, :, 1], lastq)
        last_start_r = st["last_start"]
        curr_buf = st["curr"]
        emit_any = jnp.zeros(nB, jnp.bool_)
        # emitted mem as SCALAR columns (no (B, 4) row materialization —
        # see the mems layout note in the state init)
        em_k = jnp.zeros(nB, rdt)
        em_s = jnp.zeros(nB, rdt)
        em_e = jnp.zeros(nB, rdt)
        ovf_bwd = jnp.zeros(nB, jnp.bool_)
        slot_l, row_l, push_l = [], [], []
        for t in range(KC):
            active_t = in_bwd & (t < n_proc)
            is_last = t == (n_proc - 1)
            if KC > 1 and t < KC - 1:
                res_k = jnp.where(is_last, ok_k, sub_k[t])
                res_s = jnp.where(is_last, ok_s, sub_s[t])
                piv_t = jnp.where(is_last[:, None], main_iv, sub_iv[t])
            else:  # t == KC-1 active implies is_last (n_proc <= KC)
                res_k, res_s, piv_t = ok_k, ok_s, main_iv
            fail = active_t & (~c_ok | (c_ok & (res_s < st["min_intv"])))
            emit = fail & (n_curr_r == 0) & (bw_i + 1 < last_start_r)
            # round filters: emit only seeds meeting the round's length
            slen = (piv_t[:, 2].astype(i32)) - (bw_i + 1)
            emit = emit & (slen >= min_seed_len) & ~emit_any
            em_k = jnp.where(emit, piv_t[:, 0], em_k)
            em_s = jnp.where(emit, piv_t[:, 1], em_s)
            em_e = jnp.where(emit, piv_t[:, 2], em_e)
            emit_any = emit_any | emit
            last_start_r = jnp.where(emit, bw_i + 1, last_start_r)
            # grow curr when extension survives, size distinct from last
            keep = active_t & c_ok & (res_s >= st["min_intv"])
            distinct = (n_curr_r == 0) | (res_s != last_s_r)
            push_t = keep & distinct
            curr_row = jnp.stack(
                [res_k, res_s, piv_t[:, 2].astype(rdt)], axis=1)
            # defer the buffer write: collect (slot, row, do) per t and
            # write curr ONCE after the fold — each push_row is a full
            # (B, P, 3) rewrite, and KC of them per iteration would eat
            # the iterations the fold saves
            ovf_bwd = ovf_bwd | (push_t & (n_curr_r >= P))
            slot_l.append(jnp.minimum(n_curr_r, P - 1))
            row_l.append(curr_row)
            push_l.append(push_t & (n_curr_r < P))
            n_curr_r = n_curr_r + (push_t & (n_curr_r < P)).astype(i32)
            last_s_r = jnp.where(push_t, res_s, last_s_r)
        if KC > 1:
            slots = jnp.stack(slot_l, axis=1)              # (B, KC)
            pushes = jnp.stack(push_l, axis=1)             # (B, KC)
            vals = jnp.stack(row_l, axis=1)                # (B, KC, 3)
            oh = (jnp.arange(P, dtype=i32)[None, :, None]
                  == slots[:, None, :]) & pushes[:, None, :]   # (B, P, KC)
            contrib = jnp.where(oh[..., None], vals[:, None], 0).sum(
                axis=2, dtype=rdt)                          # (B, P, 3)
            curr_buf = jnp.where(jnp.any(oh, axis=2)[..., None], contrib,
                                 curr_buf)
        else:
            curr_buf = dense.put_row(curr_buf, slot_l[0], row_l[0], push_l[0])
        # ============== PH_R3 (emit shares the mems push below) ==========
        r3_end = in_r3 & (i >= L)
        r3_amb = in_r3 & (i < L) & (qi >= 4)
        r3_ext = in_r3 & (i < L) & (qi < 4)
        hit = r3_ext & (ok_s < max_mem_intv) & ((i - x) >= min_seed_len)
        emit3 = hit & (ok_s > 0)
        # ---- the one shared mems push (bwd emit | r3 emit) ----
        # the two sources are phase-exclusive per lane. Columns push
        # independently (no (B, 4) row tensor; see the mems layout note
        # in the state init).
        push_any = emit_any | emit3
        pv_k = jnp.where(emit_any, em_k, ok_k)
        pv_s = jnp.where(emit_any, em_s, ok_s)
        pv_b = jnp.where(emit_any, (bw_i + 1).astype(rdt), x.astype(rdt))
        pv_e = jnp.where(emit_any, em_e, (i + 1).astype(rdt))
        nmm = new["n_mem"]
        ovf2 = push_any & (nmm >= M)
        wr = push_any & ~ovf2
        ohm = (jnp.arange(M, dtype=i32)[None, :]
               == jnp.minimum(nmm, M - 1)[:, None]) & wr[:, None]
        new["mem_k"] = jnp.where(ohm, pv_k[:, None], new["mem_k"])
        new["mem_s"] = jnp.where(ohm, pv_s[:, None], new["mem_s"])
        new["mem_b"] = jnp.where(ohm, pv_b[:, None], new["mem_b"])
        new["mem_e"] = jnp.where(ohm, pv_e[:, None], new["mem_e"])
        new["n_mem"] = nmm + wr.astype(i32)
        new["overflow"] = new["overflow"] | ovf2 | ovf_bwd
        new["last_start"] = jnp.where(in_bwd, last_start_r,
                                      new["last_start"])
        new["curr"] = jnp.where(in_bwd[:, None, None], curr_buf, new["curr"])
        new["n_curr"] = jnp.where(in_bwd, n_curr_r, new["n_curr"])
        nj = j + n_proc
        # dead-column shortcut: with bw_i < 0 or an ambiguous base, EVERY
        # candidate fails and no push happens, and only the first (longest;
        # ends are descending in visit order) candidate can pass the
        # last_start emit gate — so the whole column finishes in one
        # iteration instead of n_prev (saves ~12 iters/read: pivot-0
        # passes die at bw_i = -1 with a full candidate stack)
        dead = in_bwd & ((bw_i < 0) | (qi >= 4))
        row_done = in_bwd & ((nj >= st["n_prev"]) | dead)
        new["j"] = jnp.where(in_bwd, jnp.where(row_done, 0, nj), new["j"])
        bwd_finished = row_done & (new["n_curr"] == 0)
        cont2 = row_done & ~bwd_finished
        new["prev"] = jnp.where(cont2[:, None, None], new["curr"], new["prev"])
        new["n_prev"] = jnp.where(cont2, new["n_curr"], new["n_prev"])
        # curr is already built longest-first: subsequent columns iterate
        # forward
        new["rev1"] = jnp.where(cont2, False, new["rev1"])
        new["n_curr"] = jnp.where(cont2, 0, new["n_curr"])
        new["i"] = jnp.where(cont2, bw_i - 1, new["i"])
        # (when i reaches -1 the whole row fails with c < 0: curr stays
        # empty, so bwd_finished fires — no separate exit needed)
        new["phase"] = jnp.where(bwd_finished, PH_PIVOT, new["phase"])
        # round 1: advance pivot to ret; round 2: next source mem
        new["x"] = jnp.where(bwd_finished & (rnd == RD_SMEM), st["ret"], new["x"])
        new["r2i"] = jnp.where(
            bwd_finished & (rnd == RD_RESEED), st["r2i"] + 1, new["r2i"]
        )

        # PH_R3 stepwise stop/advance
        r3_stop = r3_end | r3_amb | hit
        new["x"] = jnp.where(r3_stop & in_r3, jnp.where(r3_end, L, i + 1), new["x"])
        new["phase"] = jnp.where(r3_stop, PH_PIVOT, new["phase"])
        keep3 = r3_ext & ~hit
        new["ik"] = jnp.where(
            keep3[:, None], jnp.stack([ok_k, ok_l, ok_s], axis=1), new["ik"]
        )
        new["i"] = jnp.where(keep3, i + 1, new["i"])

        return new

    def run_compacting(st, sizes):
        """Run the state machine with progressive straggler compaction:
        run the full width until at most ``sizes[0]`` lanes are still
        live, gather those lanes into a ``sizes[0]``-wide state (4x
        cheaper per iteration), recurse, and scatter the results back.
        The per-lane iteration count is long-tailed (p50 ~630 vs max
        ~1260 for 150 bp reads), so the whole batch otherwise pays the
        slowest lane's trip count at full width."""
        from bioseqdb_tpu.kernels.loops import LOOP_UNROLL

        U = max(1, min(LOOP_UNROLL, 32))
        chunk = 32

        def bodyU(_, s):
            # U state-machine steps per loop iteration amortize the
            # fixed cost of each iteration boundary (loops.chunked_while)
            for _u in range(U):
                s = body(s)
            return s

        def chunkf(s):
            return jax.lax.fori_loop(0, chunk // U, bodyU, s)

        def run_chunks(s, live_gt: int):
            return jax.lax.while_loop(
                lambda s: jnp.sum(s["phase"] != PH_DONE) > live_gt, chunkf, s
            )

        if not sizes:
            return run_chunks(st, 0)
        B2 = sizes[0]
        Bc = st["phase"].shape[0]
        st = run_chunks(st, B2)
        unfin = st["phase"] != PH_DONE
        slot = jnp.where(
            unfin, jnp.minimum(jnp.cumsum(unfin.astype(i32)) - 1, B2 - 1), B2
        )
        lane_of = jnp.full(B2 + 1, -1, i32).at[slot].set(
            jnp.arange(Bc, dtype=i32), mode="drop"
        )[:B2]
        safe = jnp.clip(lane_of, 0, Bc - 1)
        sub = {k: v[safe] for k, v in st.items()}
        sub["phase"] = jnp.where(lane_of < 0, PH_DONE, sub["phase"])
        sub = run_compacting(sub, sizes[1:])
        tgt = jnp.where(lane_of >= 0, lane_of, Bc)
        return {k: v.at[tgt].set(sub[k], mode="drop") for k, v in st.items()}

    sizes = []
    b = B
    # reseed-only entries start with a handful of live lanes, so deeper
    # compaction levels pay for themselves immediately
    floor = 256 if entry_reseed else 1024
    while b >= floor:
        b //= 2 if not sizes else 4
        sizes.append(b)
    st = run_compacting(st, sizes)
    mems5 = jnp.stack(
        [st["mem_k"], jnp.zeros_like(st["mem_k"]), st["mem_s"],
         st["mem_b"], st["mem_e"]], axis=2)
    out = dict(mems=mems5, n_mem=st["n_mem"], overflow=st["overflow"],
               iters=st["iters"], it_r1=st["it_r1"], it_r2=st["it_r2"])
    if DEBUG_CENSUS:
        for k in ("ph_census", "bwd_dead", "bwd_np1", "bwd_cols", "sr_same"):
            out[k] = st[k]
    return out
