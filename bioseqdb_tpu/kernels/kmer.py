"""Minimizer-table-assisted seeding: BWA-MEM's three seeding rounds in
O(1) dependent steps for the common case.

Role matched: the seeding half of ``mem_align1`` (reference
bwa.cpp:149) — the same job as kernels/seed.py's FM state machine, with
a different algorithmic shape. On the accelerator this was designed
for, the FM backward-extension loop was bound by the fixed cost of each
DEPENDENT gather step (~460-700 steps per read), while INDEPENDENT
gathers batched into one kernel; the GPU's costs are not measured yet
(ROADMAP Speed item 2). This module restructures seeding so the memory
traffic is a handful of large independent gathers:

1. Select the read's (k=14, w=6) minimizers — for every window of 6
   consecutive k-mer starts, the leftmost hash-minimal k-mer. The
   genome side of the same scheme is indexed at build time
   (build_kmer_table). Standard minimizer property: any exact match of
   length >= k + w - 1 = 19 = min_seed_len contains a complete window
   on both sides, whose selection depends only on window content — so
   READ and GENOME select the same position inside the match.
2. Look each selected k-mer up in the genome table (bucket offsets +
   one entry-row pair) -> candidate DIAGONALS (doubled-text position
   minus read offset). If no lookup was capped, the diagonal set
   provably contains every occurrence of every substring of length
   >= min_seed_len (each occurrence shares a selected k-mer).
3. Per diagonal, a packed match mask against the doubled text gives
   reach(b) = first mismatch at/after read position b. The top-2
   reaches over diagonals (R1, R2) at every position are enough to
   derive rounds 1 and 3 EXACTLY:
   - round 1 (SMEMs): E(b) = R1(b) is the longest-match end through b
     (exact for values >= min_seed_len: all such occurrences are on
     found diagonals). SMEM starts are exactly the strict increases of
     E (E is non-decreasing; [b, E(b)) is left-maximal iff
     E(b-1) < E(b)), gate length >= min_seed_len, and the occurrence
     count is 1 iff R2(b) < R1(b) — the unique covering diagonal IS
     the argmax, giving the seed position directly (no SA resolve).
   - round 3 (bwt_seed_strategy1): with every relevant occurrence
     count <= smax < max_mem_intv (smax = min(12, max_mem_intv - 1);
     counts of length->=19 substrings are bounded by any contained
     k-mer's bucket count), the forward scan ALWAYS stops at its first
     eligible check, so the whole round is a deterministic successor
     chase over (next-ambiguous-base, R1) — derived with vector ops +
     a short bounded pointer chase.
   - round 2 (re-seed, occ >= s+1 through a pivot) involves interval
     sizes of substrings SHORTER than k, which the diagonal set cannot
     count — but it can prove the round EMPTY: an emission requires an
     occ>=2 window of length min_seed_len containing the pivot, i.e.
     R2(w) >= w + min_seed_len for some w in (x - msl, x]. Reads
     failing that certificate (~0.2% on E. coli-scale random genomes,
     ~2% at chr20 scale — chance 19-mer repeats) run ONLY round 2 on
     the existing FM machine (kernels/seed.py reseed entry mode, a
     ~10-60-dependent-step trip instead of ~600), whose emitted mems
     are genuine rank intervals — SA-resolved downstream with exact
     bwa position order.
   Anything the fast path cannot prove exact falls back: capped
   buckets (real-genome repeat k-mers), minimizer/diagonal overflow,
   any s >= 2 round-1/3 seed (its positions would need suffix-rank
   order), non-terminating round-3 chase. Fallback reads mark
   ``overflow`` and take the existing fat-cap FM retry / host-oracle
   path — bit-exact by construction.

Eligibility is decided at Aligner.build (kmer_eligible): doubled text
< 2^31 (int32 positions), min_seed_len >= 19, replicated (non-sharded)
index. The sharded GRCh38 path keeps the FM seeder.

Exactness is pinned by tests/test_kmer_seed.py (resolved-seed equality
vs the FM path over random/repeat/ambiguous/multi-ref genomes) and the
fuzz harness run under BST_SEEDER=kmer.
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np

from bioseqdb_tpu.kernels import dense

K = 14          # k-mer length
WIN = 6         # minimizer window: k-mer starts per window
GUARANTEE = K + WIN - 1  # = 19: minimum exactly-findable match length

_BIG = 0x7FFFFFFF
_UMAX = np.uint32(0xFFFFFFFF)


# -- shared invertible hash (host uint32 numpy / device uint32 jnp) --------

def _mix32(h):
    """murmur3 finalizer on uint32 arrays — numpy and jnp compatible.
    Device and host MUST agree bit-for-bit (minimizer selection)."""
    u = h.dtype.type if isinstance(h, np.ndarray) else jnp.uint32
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    h = h * u(0xC2B2AE35)
    h = h ^ (h >> u(16))
    return h


# -- host-side table build -------------------------------------------------


class KmerMeta(typing.NamedTuple):
    """Static (hashable) table shape info — rides as a jit static arg."""

    bb: int          # bucket bits (bucket id = key >> (2K - bb))
    n_entries: int
    nrows0: int      # rows in the unshifted half of ``entries``


class KmerTable(typing.NamedTuple):
    """Device arrays of the genome minimizer table (a pytree).

    bmeta:   int32[2^bb] per-bucket (offset << 4) | min(count, 15) —
             ONE element gather per lookup (counts above the scan cap
             smax < 15 mean "capped")
    entries: int32[nrows0 + nrows1, 32] — ONE int32 per entry,
             (pos << low_bits) | low_key (bb is floored at build time
             so the pack fits 32 bits), 32 entries per 128-byte row,
             stored TWICE: rows [0, nrows0) hold entry j at row j>>5;
             rows [nrows0, ...) the same stream shifted by 16 entries.
             Any <= 8 consecutive entries then live in ONE row of one
             copy (pick by (off & 31) > 24), so a lookup is a single
             row gather. Slots past a bucket's count are never read
             (the scan is gated by the stored count), so padding and
             neighboring-bucket entries in the gathered window are
             harmless.
    """

    bmeta: jnp.ndarray
    entries: jnp.ndarray


def _host_minimizer_positions(codes: np.ndarray) -> np.ndarray:
    """Selected minimizer positions of a code array (0..3), brute
    sliding-window leftmost-argmin — the definitional form; the device
    uses an equivalent run-length formulation (tests pin equality)."""
    n = len(codes)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.uint32))
    if n < K:
        return empty
    km = np.zeros(n - K + 1, np.uint32)
    for t in range(K):
        km = (km << np.uint32(2)) | codes[t : n - K + 1 + t].astype(np.uint32)
    h = _mix32(km)
    nwin = len(h) - WIN + 1
    if nwin <= 0:
        return empty
    sel = np.zeros(len(h), bool)
    chunk = 1 << 22
    for lo in range(0, nwin, chunk):
        hi = min(lo + chunk, nwin)
        wins = np.lib.stride_tricks.sliding_window_view(
            h[lo : hi + WIN - 1], WIN)
        arg = np.argmin(wins, axis=1)  # leftmost minimum
        sel[lo + np.arange(hi - lo) + arg] = True
    return np.flatnonzero(sel).astype(np.int64), km


def build_kmer_table(pac: np.ndarray) -> tuple[dict, KmerMeta]:
    """Build the genome minimizer table over the DOUBLED text
    (forward + reverse complement, the same text the FM index is built
    on — strand handling is uniform doubled-coordinate positions, like
    SA-resolved seeds). Returns (host arrays dict, meta)."""
    pac = np.asarray(pac, np.uint8) & 3
    n_f = len(pac)
    codes = np.empty(2 * n_f, np.uint8)
    codes[:n_f] = pac
    codes[n_f:] = 3 - pac[::-1]
    sel_pos, km = _host_minimizer_positions(codes)
    keys = km[sel_pos]
    order = np.argsort(keys, kind="stable")  # pos ascending within a key
    keys_s = keys[order].astype(np.uint32)
    pos_s = sel_pos[order]
    ne = len(pos_s)
    assert 2 * n_f < (1 << 31), "kmer table requires int32 positions"
    assert ne < (1 << 27), "bmeta packs offsets into 27 bits"
    # bucket bits: load factor ~<= 1.25 chance keys per bucket, floored
    # so (pos << low_bits | low) packs into 32 bits
    bits_pos = max(int(2 * n_f - 1).bit_length(), 1)
    bb_pack = bits_pos + 2 * K - 32  # low_bits <= 32 - bits_pos
    bb = 2 * K
    if ne > 0:
        bb = int(np.ceil(np.log2(max(ne / 1.25, 2))))
    bb = max(14, bb, bb_pack)
    bb = min(bb, 26, 2 * K)
    assert bb >= bb_pack, "doubled text too large for packed entries"
    low_bits = 2 * K - bb
    bucket = (keys_s >> np.uint32(low_bits)).astype(np.int64)
    cnts = np.bincount(bucket, minlength=1 << bb)
    off = np.zeros(1 << bb, np.int64)
    np.cumsum(cnts[:-1], out=off[1:])
    bmeta = ((off << 4) | np.minimum(cnts, 15)).astype(np.int32)
    low = keys_s.astype(np.uint32) & np.uint32((1 << low_bits) - 1)
    packed = ((pos_s.astype(np.uint32) << np.uint32(low_bits)) | low
              ).view(np.int32)
    # entries stored twice (plain + shifted-by-16) so any <= 8
    # consecutive entries sit in ONE 32-entry row of one copy
    nrows0 = ne // 32 + 1
    flat = np.full(nrows0 * 32, -1, np.int32)
    flat[:ne] = packed
    e0 = flat.reshape(nrows0, 32)
    flat1 = np.full((nrows0 + 1) * 32, -1, np.int32)
    flat1[: nrows0 * 32 - 16] = flat[16:]
    e1 = flat1.reshape(nrows0 + 1, 32)
    return (
        dict(bmeta=bmeta, entries=np.concatenate([e0, e1])),
        KmerMeta(bb=bb, n_entries=ne, nrows0=nrows0),
    )


def kmer_eligible(idx, options) -> bool:
    """Can the kmer seeder hold exact parity for this (index, options)?

    - int32 positions (doubled text < 2^31); the sharded/GRCh38 path
      keeps the FM seeder;
    - min_seed_len >= 19 (the minimizer guarantee window);
    - split_len > min_seed_len + 1, so round-3 seeds (length
      min_seed_len + 1) can never qualify as round-2 reseed parents —
      the machine's reseed entry receives rounds 1 AND 3 preloaded,
      while bwa's round 2 runs before round 3 exists.
    """
    msl = int(options.min_seed_len)
    split_len = int(msl * options.reseed_factor + 0.499)
    return (
        int(idx.seq_len) < (1 << 31)
        and msl >= GUARANTEE
        and split_len > msl + 1
    )


def smax_for(max_mem_intv: int) -> int:
    """Occurrence-scan cap: counts above it fall back; must stay below
    max_mem_intv so the round-3 scan provably stops at its first
    eligible check (module docstring), <= 14 because the stored bucket
    count saturates at 15 (15 means ">= 15"), and a <= 16-entry window
    always fits ONE 32-entry row of one shifted copy (KmerTable
    layout). chr20-scale census: the cap at 8 made capped buckets the
    dominant fallback class (183/16K reads); 14 absorbs most of them."""
    if max_mem_intv <= 0:  # round 3 disabled: no constraint from it
        return 14
    return min(14, max_mem_intv - 1)


def dmax_for(meta: "KmerMeta", nmz: int = 48) -> int:
    """Diagonal-slot budget: expected chance hits per read are
    ~nmz * n_entries / 4^K (table keys matched by random k-mers), plus
    a few true diagonals; a +6-sigma margin keeps overflow-fallback
    negligible. Chunked folds process 8 diagonals at a time."""
    lam = nmz * meta.n_entries / float(4 ** K)
    d = int(lam + max(6.0 * lam ** 0.5, 5.0) + 2.0)
    return min(40, max(8, -(-d // 8) * 8))


def nmz_for(width: int) -> int:
    """Minimizer-slot budget per read: expected selections are
    ~2/(WIN+1) of the k-mer positions (measured 38.7 +- 3 for 151bp,
    max 49 over 3000 reads); cap with headroom (overflow falls back to
    the FM machine)."""
    NP = max(width - K + 1, 1)
    return max(56, -(-int(0.33 * NP) // 8) * 8)


# -- device kernel ---------------------------------------------------------


def _select_minimizers(h: jnp.ndarray, NW: int):
    """selected[b, j] — j is the leftmost argmin of some length-WIN
    window of k-mer starts. Run-length formulation: j is leftmost
    argmin of window s iff h[s..j) are all > h[j] and h(j..s+WIN) are
    all >= h[j]; some valid s exists iff the capped runs L1 (strictly
    greater, leftward) and R1 (greater-or-equal, rightward) admit one.
    Equivalent to the host's brute sliding argmin (tests pin it)."""
    B, NP = h.shape
    true_ = jnp.ones((B, NP), bool)
    L = jnp.zeros((B, NP), jnp.int32)
    R = jnp.zeros((B, NP), jnp.int32)
    runl = true_
    runr = true_
    for u in range(1, WIN):
        # h[j-u] > h[j], chained
        left = jnp.pad(h[:, :-u], ((0, 0), (u, 0)), constant_values=0)
        runl = runl & (left > h) & (jnp.arange(NP) >= u)[None, :]
        L = L + runl.astype(jnp.int32)
        right = jnp.pad(h[:, u:], ((0, 0), (0, u)), constant_values=_UMAX)
        runr = runr & (right >= h) & (jnp.arange(NP) < NP - u)[None, :]
        R = R + runr.astype(jnp.int32)
    j = jnp.arange(NP, dtype=jnp.int32)[None, :]
    s_lo = jnp.maximum(jnp.maximum(0, j - WIN + 1), j - L)
    s_hi = jnp.minimum(jnp.minimum(NW - 1, j), j + R - WIN + 1)
    return s_lo <= s_hi


def _match_reach(pac32, seq_len, cpk, amb_codes, diags, dvalid, W):
    """reach[b, d, p] = first read position >= p whose base fails to
    match the doubled text on diagonal d (W if the run reaches the read
    end). Invalid diagonals give reach == p everywhere."""
    B, DC = diags.shape
    u32 = jnp.uint32
    i32 = jnp.int32
    NW1 = (W + 15) // 16 + 1
    s0 = diags  # doubled-text position of read offset 0 (may be < 0)
    r0 = s0 >> 9  # 512 bases per packed row
    ridx = jnp.stack([r0, r0 + 1], axis=-1)  # (B, DC, 2)
    rows = pac32[jnp.clip(ridx, 0, pac32.shape[0] - 1)]  # (B, DC, 2, 32)
    words64 = rows.reshape(B * DC, 64)
    woff = ((s0 >> 4) - (r0 << 5)).reshape(-1)  # word offset in [0, 32)
    wwin = dense.shift_left(words64, woff, 32)[:, : NW1 + 1]
    wu = jax.lax.bitcast_convert_type(wwin, u32)
    b2 = (2 * (s0 & 15)).astype(u32).reshape(-1, 1)  # bit offset, 0..30
    hi = jnp.where(b2 > 0, wu[:, 1:] >> jnp.minimum(u32(32) - b2, u32(31)),
                   u32(0))
    rw = jnp.where(b2 > 0, (wu[:, :-1] << b2) | hi, wu[:, :-1])  # (B*DC, NW1)
    x = rw ^ jax.lax.bitcast_convert_type(
        cpk[:, None, :].repeat(DC, 1).reshape(B * DC, NW1), u32)
    eq2 = (~(x | (x >> u32(1)))) & u32(0x55555555)  # bit 30-2g: group g equal
    g = (u32(30) - 2 * jnp.arange(16, dtype=u32))[None, None, :]
    mbits = ((eq2[:, :, None] >> g) & u32(1)).astype(jnp.bool_)
    match = mbits.reshape(B, DC, NW1 * 16)[:, :, :W]
    pos = jnp.arange(W, dtype=i32)[None, None, :]
    tref = s0[:, :, None] + pos
    match = (match & ~amb_codes[:, None, :] & dvalid[:, :, None]
             & (tref >= 0) & (tref < seq_len))
    # int16 positions (W <= a few thousand): halves the bytes of the
    # largest per-chunk tensor and its cummin
    nz = jnp.where(match, jnp.int16(0x7FFF), pos.astype(jnp.int16))
    reach = jnp.flip(jax.lax.cummin(jnp.flip(nz, axis=2), axis=2), axis=2)
    return jnp.minimum(reach, jnp.int16(W)).astype(i32)


@functools.partial(
    jax.jit,
    static_argnames=("bb", "smax", "dmax", "nmz", "min_seed_len",
                     "split_len", "split_width", "max_mem_intv", "max_mem",
                     "stage"),
)
def collect_seeds_kmer(
    kt: KmerTable,
    pac_dev: jnp.ndarray,     # packed doubled rows (extend.pack_doubled_rows)
    seq_len,                  # () int — doubled text length
    codes: jnp.ndarray,       # int32[B, W] 0..3 bases, >=4 ambiguous/padding
    lens: jnp.ndarray,        # int32[B]
    bb: int,
    min_seed_len: int,
    split_len: int,
    split_width: int,
    max_mem_intv: int,
    smax: int = 12,
    dmax: int = 24,
    nmz: int = 64,
    max_mem: int = 16,
    stage: str = "all",
):
    """Rounds 1 and 3 of BWA-MEM seeding from the minimizer table.

    Returns dict with
      mem_pos int32[B, M]  doubled-text position of each (s==1) seed
      mem_s/mem_b/mem_e int32[B, M]  occurrence count / query span
      n_mem int32[B]
      needs_r2 bool[B]   round 2 not provably empty -> run the FM
                         machine's reseed entry on these lanes
      overflow bool[B]   fast path cannot hold exactness -> FM fallback
    """
    B, W = codes.shape
    i32 = jnp.int32
    u32 = jnp.uint32
    M = max_mem
    msl = min_seed_len
    codes = codes.astype(i32)
    seq_len = jnp.asarray(seq_len, i32)

    out0 = dict(
        mem_pos=jnp.zeros((B, M), i32), mem_s=jnp.zeros((B, M), i32),
        mem_b=jnp.zeros((B, M), i32), mem_e=jnp.zeros((B, M), i32),
        n_mem=jnp.zeros(B, i32), needs_r2=jnp.zeros(B, jnp.bool_),
        overflow=jnp.zeros(B, jnp.bool_),
    )
    NP = W - K + 1
    NW = NP - WIN + 1
    if NP < 1 or NW < 1:  # reads too short for any >=19bp seed
        return out0

    # ---- read k-mers + minimizer selection ----
    # log-doubling build: 4 shift-or passes instead of K=14 column
    # passes (pad 2 columns so the 16-mer ladder covers every start)
    cpad = jnp.pad(codes, ((0, 0), (0, 16 - K)), constant_values=4)
    k1 = (cpad & 3).astype(u32)
    v1 = cpad < 4
    k2 = (k1[:, :-1] << u32(2)) | k1[:, 1:]
    v2 = v1[:, :-1] & v1[:, 1:]
    k4 = (k2[:, :-2] << u32(4)) | k2[:, 2:]
    v4 = v2[:, :-2] & v2[:, 2:]
    k8 = (k4[:, :-4] << u32(8)) | k4[:, 4:]
    v8 = v4[:, :-4] & v4[:, 4:]
    k16 = (k8[:, :-8] << u32(16)) | k8[:, 8:]
    km = (k16 >> u32(2 * (16 - K)))[:, :NP]  # top 2K bits = K-mer at p
    kvalid = (v8[:, :NP] & v4[:, 8 : 8 + NP] & v2[:, 12 : 12 + NP])
    kvalid = kvalid & (jnp.arange(NP, dtype=i32)[None, :] + K
                       <= lens[:, None])
    h = jnp.where(kvalid, _mix32(km), _UMAX)
    if stage == "hash":  # profiling cut points (tools/ab_kmer_seed.py)
        return h
    sel = _select_minimizers(h, NW)
    if stage == "select":
        return sel

    # compact selected positions (+ keys/validity payload) to nmz slots
    skey = jnp.where(sel, jnp.arange(NP, dtype=i32)[None, :], _BIG)
    skey_s, km_s, kval_s = jax.lax.sort(
        (skey, km, kvalid.astype(i32)), dimension=1, num_keys=1)
    nmz_c = min(nmz, NP)
    mzpos = skey_s[:, :nmz_c]
    mzkey = km_s[:, :nmz_c]
    mzok = (mzpos < _BIG) & (kval_s[:, :nmz_c] > 0)
    mz_overflow = (skey_s[:, nmz_c] < _BIG) if NP > nmz_c \
        else jnp.zeros(B, jnp.bool_)
    if stage == "mzcompact":
        return mzpos + mzkey.astype(i32)

    # ---- table lookups: 1 element gather + 1 entry-row gather ----
    low_bits = 2 * K - bb
    bkt = (mzkey >> u32(low_bits)).astype(i32)
    bkt = jnp.where(mzok, bkt, 0)
    bm = kt.bmeta[bkt]
    o0 = bm >> 4
    cnt = bm & 15
    capped = mzok & (cnt > smax)
    # a <= 16-entry window always sits in ONE row of one of the two
    # shifted copies (KmerTable docstring): E0 when it fits before
    # column 32, else the 16-shifted copy
    nrows0 = (kt.entries.shape[0] - 1) // 2
    col0 = o0 & 31
    use1 = col0 > 32 - smax
    row = jnp.where(use1, nrows0 + ((o0 - 16) >> 5), o0 >> 5)
    col = jnp.where(use1, col0 - 16, col0)
    erows = kt.entries[
        jnp.clip(row, 0, kt.entries.shape[0] - 1)].reshape(B * nmz_c, 32)
    aligned = dense.shift_left(
        erows, col.reshape(-1), 24)[:, :smax]
    ev = jax.lax.bitcast_convert_type(
        aligned.reshape(B, nmz_c, smax), u32)
    e_pos = (ev >> u32(low_bits)).astype(i32)
    e_low = (ev & u32((1 << low_bits) - 1)).astype(i32)
    t_ok = jnp.arange(smax, dtype=i32)[None, None, :] < cnt[:, :, None]
    lowq = (mzkey & u32((1 << low_bits) - 1)).astype(i32)
    hit = (mzok & ~capped)[:, :, None] & t_ok & (e_low == lowq[:, :, None])
    diag_all = jnp.where(hit, e_pos - mzpos[:, :, None], _BIG)
    if stage == "lookup":
        return diag_all

    # ---- dedup diagonals: successive masked minima (dmax is small, so
    # dmax passes of a (B, nmz*smax) min-reduce replace two full sorts;
    # chosen on another accelerator, not measured on the GPU) ----
    flat = diag_all.reshape(B, nmz_c * smax)
    DC = min(dmax, flat.shape[1])
    cur = jnp.full((B,), -(1 << 30), i32)
    dlist = []
    for _ in range(DC):
        nxt = jnp.where(flat > cur[:, None], flat, _BIG).min(axis=1)
        dlist.append(nxt)
        cur = jnp.where(nxt < _BIG, nxt, cur)
    diags = jnp.stack(dlist, axis=1)
    dvalid = diags < _BIG
    d_overflow = (jnp.where(flat > cur[:, None], flat, _BIG).min(axis=1)
                  < _BIG)
    if stage == "dedup":
        return diags

    # ---- per-diagonal reach -> top-2 statistics over diagonals ----
    from bioseqdb_tpu.kernels.seed import _pack_streams

    cpk, _abm, _ = _pack_streams(codes, 0)
    amb = codes >= 4
    pac32 = pac_dev.reshape(-1, 32)
    posW0 = jnp.arange(W, dtype=i32)[None, :]
    R1 = jnp.zeros((B, W), i32)
    I1 = jnp.zeros((B, W), i32)
    R2 = jnp.zeros((B, W), i32)
    cnt_r3 = jnp.zeros((B, W), i32)  # occ([x, x+msl+1)) per position
    CH = 8
    for c0 in range(0, DC, CH):
        dch = diags[:, c0 : c0 + CH]
        vch = dvalid[:, c0 : c0 + CH]
        reach = _match_reach(pac32, seq_len, cpk, amb, dch, vch, W)
        m1c = reach.max(axis=1)
        a1c = reach.argmax(axis=1).astype(i32)  # first max
        oh = jnp.arange(dch.shape[1], dtype=i32)[None, :, None] == a1c[:, None, :]
        m2c = jnp.where(oh, -1, reach).max(axis=1)
        # merge (R1, I1, R2) with (m1c, c0+a1c, m2c)
        take_new = m1c > R1
        R2 = jnp.maximum(jnp.minimum(R1, m1c), jnp.maximum(R2, m2c))
        I1 = jnp.where(take_new, a1c + c0, I1)
        R1 = jnp.maximum(R1, m1c)
        cnt_r3 = cnt_r3 + (reach >= posW0[:, None, :] + msl + 1).sum(
            axis=1).astype(i32)
    posW = posW0
    R1 = jnp.maximum(R1, posW)  # no diagonal: empty reach
    R2 = jnp.maximum(R2, posW)
    if stage == "reach":
        return R1 + R2 + cnt_r3
    d1 = dense.lookup(diags, I1)  # diagonal value of the argmax, (B, W)

    # ---- round 1: SMEMs = strict increases of E = R1 ----
    E = R1
    Eprev = jnp.pad(E[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    emit1 = (E > Eprev) & (E - posW >= msl)
    multi1 = emit1 & (R2 >= E)  # occurrence count >= 2: needs SA order
    # compact round-1 emissions into mem slots
    slot1 = jnp.cumsum(emit1.astype(i32), axis=1) - 1
    n_r1 = jnp.sum(emit1, axis=1).astype(i32)
    oh1 = ((jnp.arange(M, dtype=i32)[None, None, :] == slot1[:, :, None])
           & emit1[:, :, None])                       # (B, W, M)
    put = lambda v: jnp.where(oh1, v[:, :, None], 0).sum(axis=1, dtype=i32)
    mem_b = put(posW * jnp.ones((B, 1), i32))
    mem_e = put(E)
    mem_pos = put(d1 + posW)
    mem_s = put(jnp.ones((B, W), i32))
    r1_overflow = n_r1 > M

    # ---- round 2 certificate: occ>=2 window of length msl through a
    # reseed pivot? (module docstring) ----
    rep = R2 >= posW + msl                     # window [b, b+msl) occ >= 2
    last_rep = jax.lax.cummax(jnp.where(rep, posW, -1), axis=1)  # (B, W)
    mm = jnp.arange(M, dtype=i32)[None, :]
    is_mem = mm < n_r1[:, None]
    trigger = is_mem & (mem_e - mem_b >= split_len) & (mem_s <= split_width)
    pivot = jnp.clip((mem_b + mem_e) >> 1, 0, W - 1)
    # needs(x): some w in (x - msl, x] with rep(w) — the -1 sentinel
    # (no rep position at/left of x) must not satisfy early pivots
    lr_at = dense.lookup(last_rep, pivot)            # (B, M)
    needs_p = trigger & (lr_at >= 0) & (lr_at > pivot - msl)
    needs_r2 = needs_p.any(axis=1)
    if stage == "r1":
        return dict(mem_b=mem_b, mem_e=mem_e, needs_r2=needs_r2)

    # ---- round 3: deterministic successor chase ----
    n_mem = n_r1
    r3_multi = jnp.zeros(B, jnp.bool_)
    r3_stuck = jnp.zeros(B, jnp.bool_)
    if max_mem_intv > 0:
        # next invalid base at/after i (W if none), and next valid base
        inval = jnp.where(amb | (posW >= lens[:, None]), posW, _BIG)
        namb = jnp.minimum(
            jnp.flip(jax.lax.cummin(jnp.flip(inval, 1), 1), 1), W)
        nvalid = jnp.minimum(jnp.flip(jax.lax.cummin(
            jnp.flip(jnp.where(~amb & (posW < lens[:, None]), posW, _BIG),
                     1), 1), 1), W)
        # successor(x) for a VALID scan start x (bwt_seed_strategy1 with
        # every occ <= smax < max_mem_intv): the scan provably stops at
        # its first eligible check i = x + msl (pattern [x, x+msl+1)),
        # UNLESS an invalid base (ambiguous or past end-of-read) at
        # i in (x, x+msl] ends it first with restart at i + 1 (an
        # end-of-read exit restarts at >= len — same termination).
        # x itself is always valid (the chase lands on nvalid).
        stop_i = posW + msl
        clean = namb > stop_i               # no invalid base in [x, x+msl]
        succ_v = jnp.where(clean, stop_i + 1, namb + 1)
        emit_v = clean & (cnt_r3 >= 1)      # clean implies x+msl < len
        # chase from the first valid position; each step lands on the
        # next VALID position (invalid runs are skipped wholesale, so
        # every step consumes a whole invalid run or msl+1 positions)
        sv0 = jnp.minimum(nvalid[:, 0], W)
        spos = jnp.where(emit_v, d1 + posW, 0)
        T = W // (msl + 1) + 18
        cur = sv0
        n = n_mem
        ovf3 = jnp.zeros(B, jnp.bool_)
        m3 = jnp.zeros(B, jnp.bool_)
        mem_pos_, mem_s_, mem_b_, mem_e_ = mem_pos, mem_s, mem_b, mem_e
        for _ in range(T):
            live = cur < W
            curc = jnp.clip(cur, 0, W - 1)
            em = live & dense.lookup(emit_v, curc[:, None])[:, 0]
            s_here = dense.lookup(cnt_r3, curc[:, None])[:, 0]
            p_here = dense.lookup(spos, curc[:, None])[:, 0]
            m3 = m3 | (em & (s_here >= 2))
            wr = em & (n < M)
            ovf3 = ovf3 | (em & (n >= M))
            ohm = (mm == jnp.minimum(n, M - 1)[:, None]) & wr[:, None]
            mem_pos_ = jnp.where(ohm, p_here[:, None], mem_pos_)
            mem_s_ = jnp.where(ohm, s_here[:, None], mem_s_)
            mem_b_ = jnp.where(ohm, curc[:, None], mem_b_)
            mem_e_ = jnp.where(ohm, (curc + msl + 1)[:, None], mem_e_)
            n = n + wr.astype(i32)
            nx = dense.lookup(succ_v, curc[:, None])[:, 0]
            nxv = dense.lookup(nvalid, jnp.clip(nx, 0, W - 1)[:, None])[:, 0]
            cur = jnp.where(live, jnp.where(nx >= W, W, nxv), W)
        r3_stuck = cur < W  # chase budget exhausted (amb-riddled read)
        r3_multi = m3
        n_mem = n
        mem_pos, mem_s, mem_b, mem_e = mem_pos_, mem_s_, mem_b_, mem_e_
        r1_overflow = r1_overflow | ovf3

    overflow = (mz_overflow | capped.any(axis=1) | d_overflow
                | multi1.any(axis=1) | r1_overflow | r3_multi | r3_stuck)
    # fallback-cause bitmask (telemetry; tools/ab_kmer_seed.py)
    why = (mz_overflow.astype(i32)
           | (capped.any(axis=1).astype(i32) << 1)
           | (d_overflow.astype(i32) << 2)
           | (multi1.any(axis=1).astype(i32) << 3)
           | (r1_overflow.astype(i32) << 4)
           | (r3_multi.astype(i32) << 5)
           | (r3_stuck.astype(i32) << 6))
    return dict(
        mem_pos=mem_pos, mem_s=mem_s, mem_b=mem_b, mem_e=mem_e,
        n_mem=n_mem, needs_r2=needs_r2 & ~overflow, overflow=overflow,
        why=why,
    )
