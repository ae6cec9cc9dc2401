"""Batched FM-index operations on device (JAX).

The device-side counterpart of index/fmindex.py's scalar reference
queries — every function here must agree with it bit-for-bit
(tests/test_fm_device.py). This is where the reference's per-read
``bwt_occ``/``bwt_2occ4`` pointer-chasing (libbwa, consumed at
bwa.cpp:149) becomes batched device work: one row gather from the
interleaved ``blocks`` array per rank query, then vectorized 2-bit
popcounts, batched over thousands of read lanes.

Rank values follow the index scale: int32 below 2^31 doubled bases,
int64 beyond (FMDevice.from_host auto-selects; int64 requires jax x64).
The packed tables stay int32 at any scale thanks to the relative minor
checkpoints; human-scale capacity additionally shards tables by BWT
interval (SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bioseqdb_tpu.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK, FMIndex
from bioseqdb_tpu.kernels.dense import pick as _pick

# mask of the first v bases of a packed big-endian word, v in [0, 16]
_MASK_TABLE = np.zeros(17, dtype=np.uint32)
for _v in range(17):
    _MASK_TABLE[_v] = (0x55555555 << (2 * (16 - _v))) & 0xFFFFFFFF if _v else 0

_LOG2_OCC_BLOCK = 7
assert OCC_BLOCK == 1 << _LOG2_OCC_BLOCK
_LOG2_MAJOR = MAJOR_BLOCKS.bit_length() - 1
assert MAJOR_BLOCKS == 1 << _LOG2_MAJOR


OCT_BLOCKS = 8   # Occ blocks per device row
OCT_COLS = 128   # int32 per device row: 96 Occ + 32 SA-mark words


def pack_oct(blocks: np.ndarray, sa_bits: np.ndarray | None = None
             ) -> np.ndarray:
    """Host (n_blocks, 12) Occ table -> device octo layout (n/8, 128).

    The row is a FULL 128 int32: cols 0:96 hold the 8 Occ blocks (4
    checkpoint + 8 packed-text words each), cols 96:128 hold the 8
    blocks' SA-mark bitmap words (``sa_bits[:, 1:]``, 4 words per 128
    ranks), so the seeding loop's in-loop fast-forward runs LF walks +
    marked-rank checks through its ONE shared gather. The width was
    chosen for another accelerator's tiled layout, which pads a minor
    dim to 128 elements; it is not measured on the GPU (ROADMAP Speed
    item 7).

    The mark words of rank-block ``b`` land in octo row ``b >> 3`` cols
    ``96 + 4*(b & 7)``; note marks are RANK-indexed while Occ blocks are
    stored-position-indexed (they differ by one past ``primary``) — the
    in-row consumer handles the off-by-one block-boundary case
    (kernels/seed.py in-loop fast-forward)."""
    blocks = np.asarray(blocks)
    n = blocks.shape[0]
    if sa_bits is not None:
        n = max(n, np.asarray(sa_bits).shape[0])
    n8 = -(-n // OCT_BLOCKS) * OCT_BLOCKS
    out = np.zeros((n8 // OCT_BLOCKS, OCT_COLS), np.int32)
    bb = np.zeros((n8, 12), np.int32)
    bb[: blocks.shape[0]] = blocks
    out[:, :96] = bb.reshape(-1, 96)
    if sa_bits is not None:
        mm = np.zeros((n8, 4), np.int32)
        mm[: sa_bits.shape[0]] = np.asarray(sa_bits)[:, 1:]
        out[:, 96:] = mm.reshape(-1, 32)
    return out


class FMDevice(NamedTuple):
    """FM-index arrays resident on device. A pytree of jnp arrays.

    Device layouts are 128-int32-row-friendly (see pack_oct): ``blocks``
    holds 8 Occ blocks per 96-int32 row; the SA-mark bit-rank table is
    split into flat 1-D ``sa_cnt`` (per-128-rank counts) and
    ``sa_words`` (the mark bitmap as int32 words — word of rank r is
    simply ``sa_words[r >> 5]``)."""

    L2: jnp.ndarray          # (5,) int32
    primary: jnp.ndarray     # () int32
    blocks: jnp.ndarray      # (n_blocks/8, 128) int32 octo rows (pack_oct)
    sa_sample: jnp.ndarray   # (n_marked,) int32 SA values of marked ranks
    sa_cnt: jnp.ndarray      # (nb,) int32 marks before each 128-rank row
    sa_words: jnp.ndarray    # (nb*4,) int32 mark bitmap words
    occ_majors: jnp.ndarray  # (nm, 4) int32 major Occ checkpoints
    sa_majors: jnp.ndarray   # (nm2,) int32 major mark-count checkpoints
    ref_offsets: jnp.ndarray # (n_refs,) int32
    ref_lens: jnp.ndarray    # (n_refs,) int32
    l_pac: jnp.ndarray       # () int32
    seq_len: jnp.ndarray     # () int32

    @classmethod
    def from_host(cls, idx: FMIndex, device=None,
                  rank_dtype=None) -> "FMDevice":
        """Device arrays for an index. Rank-valued arrays use
        ``rank_dtype`` (auto: int64 when the index exceeds int32 rank
        range — requires jax x64 to be enabled, e.g. via
        ``jax.enable_x64()``); the packed tables stay int32
        by construction (relative minor checkpoints)."""
        if rank_dtype is None:
            rank_dtype = jnp.int64 if idx.seq_len + 1 >= 2**31 else jnp.int32
        if rank_dtype == jnp.int64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "index exceeds int32 rank range; enable x64 "
                "(jax.enable_x64) to run it on device"
            )
        putr = lambda x: jax.device_put(jnp.asarray(np.asarray(x), rank_dtype), device)
        put32 = lambda x: jax.device_put(jnp.asarray(np.asarray(x), jnp.int32), device)
        sa_bits = np.ascontiguousarray(np.asarray(idx.sa_bits))
        return cls(
            L2=putr(idx.L2),
            primary=putr(idx.primary),
            blocks=put32(pack_oct(idx.blocks, sa_bits)),
            sa_sample=putr(idx.sa_sample),
            sa_cnt=put32(sa_bits[:, 0]),
            sa_words=put32(sa_bits[:, 1:].reshape(-1)),
            occ_majors=putr(idx.occ_majors),
            sa_majors=putr(idx.sa_majors),
            ref_offsets=putr(idx.ref_offsets),
            ref_lens=putr(idx.ref_lens),
            l_pac=putr(idx.l_pac),
            seq_len=putr(idx.seq_len),
        )

    @property
    def rank_dtype(self):
        return self.sa_sample.dtype

    @property
    def n_block_rows(self) -> int:
        """Addressable Occ block count (including octo padding rows)."""
        return self.blocks.shape[0] * OCT_BLOCKS


def _small_rows(table: jnp.ndarray, idx: jnp.ndarray, limit: int = 128):
    """Row lookup that goes dense (one-hot select) when the table is
    small: for the handful-of-rows major-checkpoint tables a masked
    reduction replaces a per-row gather inside loop bodies (chosen on
    another accelerator; not measured on the GPU)."""
    n = table.shape[0]
    if n > limit:
        return table[idx]
    tab = table.reshape((1,) * idx.ndim + table.shape)
    oh = jnp.arange(n, dtype=jnp.int32).reshape(
        (1,) * idx.ndim + (n,) + (1,) * (table.ndim - 1)
    ) == idx.reshape(idx.shape + (1,) * table.ndim)
    return jnp.where(oh, tab, 0).sum(axis=idx.ndim, dtype=table.dtype)


def _lut(table: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Dense lookup into a tiny 1-D table (e.g. L2[c]) — avoids a
    per-row gather for (B,)-shaped code indexing."""
    return _pick(jnp.broadcast_to(table, c.shape + table.shape), c, axis=-1)


def _row_counts(row: jnp.ndarray, c: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Count code ``c`` within the first ``r`` bases of a gathered block row.

    row: (..., 12) int32; c, r broadcastable to row[..., 0].shape.
    """
    words = jax.lax.bitcast_convert_type(row[..., 4:], jnp.uint32)  # (..., 8)
    pat = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    x = words ^ pat
    y = ~(x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
    v = jnp.clip(r[..., None] - 16 * jnp.arange(8, dtype=jnp.int32), 0, 16)
    mask = jnp.asarray(_MASK_TABLE)[v]
    return jax.lax.population_count(y & mask).sum(axis=-1).astype(jnp.int32)


def _table_row(table: jnp.ndarray, blk: jnp.ndarray, axis: str | None):
    """Gather table rows by index. With ``axis`` set (BWT-interval
    sharding; the table holds this shard's row range), out-of-range rows
    read as a masked dummy and the caller's result must be psum'd over
    ``axis`` — each global row is owned by exactly one shard."""
    if axis is None:
        return table[blk], None
    rps = table.shape[0]
    base = jax.lax.axis_index(axis).astype(jnp.int32) * rps
    local = blk - base
    mine = (local >= 0) & (local < rps)
    row = table[jnp.clip(local, 0, rps - 1)]
    return row, mine


def _block_row(fm: FMDevice, blk: jnp.ndarray, axis: str | None):
    """Gather the 12-int32 Occ block row ``blk`` from the octo layout
    (pack_oct: 8 blocks per 96-int32 device row).

    The 128-int32 row width was chosen on another accelerator, where
    wide row gathers were cheaper per row and matched its tiled layout;
    it is not measured on the GPU (ROADMAP Speed item 7)."""
    row128, mine = _table_row(fm.blocks, blk >> 3, axis)
    sub = row128[..., :96].reshape(row128.shape[:-1] + (OCT_BLOCKS, 12))
    pick_idx = jnp.broadcast_to((blk & 7).astype(jnp.int32)[..., None],
                                blk.shape + (12,))
    return _pick(sub, pick_idx, axis=-2), mine


def _owner_sum(val: jnp.ndarray, mine, axis: str | None) -> jnp.ndarray:
    if axis is None:
        return val
    shaped = mine
    while shaped.ndim < val.ndim:
        shaped = shaped[..., None]
    return jax.lax.psum(jnp.where(shaped, val, 0), axis)


def _occ_major(fm: FMDevice, blk, c):
    """Major-checkpoint contribution for global block indices (the minor
    counts in `blocks` are relative to these every MAJOR_BLOCKS rows)."""
    m = jnp.clip(blk >> _LOG2_MAJOR, 0, fm.occ_majors.shape[0] - 1)
    return _pick(_small_rows(fm.occ_majors, m), c, axis=-1)


def occ_stored(fm: FMDevice, c, j, axis: str | None = None) -> jnp.ndarray:
    """Count of code c in the stored BWT prefix [0, j). Batched."""
    blk = j >> _LOG2_OCC_BLOCK
    r = j & (OCC_BLOCK - 1)
    row, mine = _block_row(fm, blk, axis)
    ckpt = _pick(row[..., :4], c, axis=-1)
    return _owner_sum(ckpt + _row_counts(row, c, r), mine, axis) + _occ_major(fm, blk, c)


def occB(fm: FMDevice, c, r, axis: str | None = None) -> jnp.ndarray:
    """Count of code c in the conceptual BWT prefix B[0, r) (skips $)."""
    return occ_stored(fm, c, r - (r > fm.primary).astype(r.dtype), axis)


def occ4_stored(fm: FMDevice, j, axis: str | None = None) -> jnp.ndarray:
    """Counts of all four codes in [0, j). Returns shape (..., 4)."""
    blk = j >> _LOG2_OCC_BLOCK
    r = j & (OCC_BLOCK - 1)
    row, mine = _block_row(fm, blk, axis)
    cs = jnp.arange(4, dtype=jnp.int32)
    cnt = _row_counts(row[..., None, :], jnp.broadcast_to(cs, j.shape + (4,)),
                      r[..., None])
    m = jnp.clip(blk >> _LOG2_MAJOR, 0, fm.occ_majors.shape[0] - 1)
    return _owner_sum(row[..., :4] + cnt, mine, axis) + _small_rows(fm.occ_majors, m)


def occ4B(fm: FMDevice, r, axis: str | None = None) -> jnp.ndarray:
    return occ4_stored(fm, r - (r > fm.primary).astype(r.dtype), axis)


def occ4_from_quad(fm: FMDevice, q128, blk, off, mine,
                   axis: str | None = None) -> jnp.ndarray:
    """occ4 at a stored position from an ALREADY-GATHERED 128-int32 octo
    row (callers share row fetches between rank queries whose positions
    land in the same octo row).

    q128: (..., 128) int32 octo row containing block ``blk``;
    blk = j >> 7, off = j & 127 for stored position j; ``mine`` is the
    shard-ownership mask from the row fetch (None when unsharded).
    Must equal occ4_stored(fm, j) whenever q128 is blk's octo row."""
    sub = q128[..., :96].reshape(q128.shape[:-1] + (OCT_BLOCKS, 12))
    pick_idx = jnp.broadcast_to((blk & 7).astype(jnp.int32)[..., None],
                                blk.shape + (12,))
    row = _pick(sub, pick_idx, axis=-2)
    cs = jnp.arange(4, dtype=jnp.int32)
    cnt = _row_counts(row[..., None, :], jnp.broadcast_to(cs, blk.shape + (4,)),
                      off[..., None])
    m = jnp.clip(blk >> _LOG2_MAJOR, 0, fm.occ_majors.shape[0] - 1)
    return _owner_sum(row[..., :4] + cnt, mine, axis) + _small_rows(fm.occ_majors, m)


def occ4_and_block(fm: FMDevice, q128, blk, off, mine,
                   axis: str | None = None):
    """occ4_from_quad that ALSO returns the picked 12-int32 block row —
    the 8-way pick happens once and consumers (the seeding loop's
    fast-forward LF/mark decode) reuse it instead of re-picking."""
    sub = q128[..., :96].reshape(q128.shape[:-1] + (OCT_BLOCKS, 12))
    pick_idx = jnp.broadcast_to((blk & 7).astype(jnp.int32)[..., None],
                                blk.shape + (12,))
    row = _pick(sub, pick_idx, axis=-2)
    cs = jnp.arange(4, dtype=jnp.int32)
    cnt = _row_counts(row[..., None, :], jnp.broadcast_to(cs, blk.shape + (4,)),
                      off[..., None])
    m = jnp.clip(blk >> _LOG2_MAJOR, 0, fm.occ_majors.shape[0] - 1)
    occ4 = _owner_sum(row[..., :4] + cnt, mine, axis) + _small_rows(
        fm.occ_majors, m)
    return occ4, row


def quad_table(blocks: jnp.ndarray) -> jnp.ndarray:
    """Quad-row view of an octo blocks table: (n/8, 128) -> (n/4, 48)
    with the SA-mark columns dropped (4 Occ blocks per 48-int32 row).

    The seeding loop's shared fetch reads whole rows; 48-int32 rows cut
    the gathered bytes 2.7x and the 8-way block pick to a 4-way pick
    over 1/3 the input. Callers keep it only while the octo layout's
    mark columns are not needed."""
    n8 = blocks.shape[0]
    occ = blocks[:, :96]
    return occ.reshape(n8 * 2, 48)


def occ_rows_for_q(fm: FMDevice, tab_q: jnp.ndarray, r: jnp.ndarray,
                   axis: str | None = None):
    """occ_rows_for against a quad_table: returns (row48, blk, off, mine)."""
    j = r - (r > fm.primary).astype(r.dtype)
    blk = j >> _LOG2_OCC_BLOCK
    row48, mine = _table_row(tab_q, blk >> 2, axis)
    return row48, blk, (j & (OCC_BLOCK - 1)).astype(jnp.int32), mine


def occ4_and_block_q(fm: FMDevice, q48, blk, off, mine,
                     axis: str | None = None):
    """occ4_and_block decoding from gathered 48-int32 quad rows."""
    sub = q48.reshape(q48.shape[:-1] + (4, 12))
    pick_idx = jnp.broadcast_to((blk & 3).astype(jnp.int32)[..., None],
                                blk.shape + (12,))
    row = _pick(sub, pick_idx, axis=-2)
    cs = jnp.arange(4, dtype=jnp.int32)
    cnt = _row_counts(row[..., None, :], jnp.broadcast_to(cs, blk.shape + (4,)),
                      off[..., None])
    m = jnp.clip(blk >> _LOG2_MAJOR, 0, fm.occ_majors.shape[0] - 1)
    occ4 = _owner_sum(row[..., :4] + cnt, mine, axis) + _small_rows(
        fm.occ_majors, m)
    return occ4, row


def occ_rows_for(fm: FMDevice, r: jnp.ndarray, axis: str | None = None):
    """Fetch the octo rows containing the conceptual-prefix positions
    ``r`` (one fused row gather). Returns (row96, blk, off, mine) with
    blk/off the stored block index and in-block offset — the inputs
    ``occ4_from_quad`` needs. Splitting the fetch from the decode lets
    callers reuse the raw rows for extra decodes (the multi-candidate
    backward pass in kernels/seed.py)."""
    j = r - (r > fm.primary).astype(r.dtype)
    blk = j >> _LOG2_OCC_BLOCK
    row128, mine = _table_row(fm.blocks, blk >> 3, axis)
    return row128, blk, (j & (OCC_BLOCK - 1)).astype(jnp.int32), mine


def occ_c_from_pair(fm: FMDevice, rowsA: jnp.ndarray, rowsB: jnp.ndarray,
                    octA: jnp.ndarray, c: jnp.ndarray,
                    p: jnp.ndarray) -> jnp.ndarray:
    """Single-code occ in the conceptual prefix [0, p), decoded from one
    of TWO already-fetched octo rows (a covering pair): the row actually
    containing p's block is selected by octo index. Only valid when p's
    stored block lies in rowsA's or rowsB's octo row — the caller
    guarantees it (nested candidate intervals inside a covering span).
    Unsharded only."""
    jp = p - (p > fm.primary).astype(p.dtype)
    blkp = jp >> _LOG2_OCC_BLOCK
    useA = (blkp >> 3) == octA
    row128 = jnp.where(useA[..., None], rowsA, rowsB)
    sub = row128[..., :96].reshape(row128.shape[:-1] + (OCT_BLOCKS, 12))
    pick_idx = jnp.broadcast_to((blkp & 7).astype(jnp.int32)[..., None],
                                blkp.shape + (12,))
    row = _pick(sub, pick_idx, axis=-2)
    ckpt = _pick(row[..., :4], c, axis=-1)
    cnt = _row_counts(row, c, (jp & (OCC_BLOCK - 1)).astype(jnp.int32))
    return ckpt + cnt + _occ_major(fm, blkp, c)


def backward_ext(fm: FMDevice, lo, hi, c, axis: str | None = None):
    """Extend pattern interval [lo, hi) by prepending code c. Batched.

    The two rank queries issue as ONE fused gather (half the fixed
    per-step gather-kernel cost of separate calls)."""
    C = _lut(fm.L2, c) + 1
    both = occB(fm, jnp.concatenate([c, c]), jnp.concatenate([lo, hi]), axis)
    n = lo.shape[0]
    return C + both[:n], C + both[n:]


def backward_search(fm: FMDevice, codes: jnp.ndarray, lens: jnp.ndarray):
    """Exact-match intervals for a batch of reads.

    codes: int32[B, W] (0..3 bases, >=4 ambiguous), lens: int32[B].
    Returns (lo, hi) int32[B]; empty interval (0, 0) on no match or any
    ambiguous base.
    """
    B, W = codes.shape
    n1 = fm.seq_len + 1

    def step(t, state):
        lo, hi = state
        # process column lens-1-t (right to left); masked when t >= lens
        idx = jnp.clip(lens - 1 - t, 0, W - 1)
        c = _pick(codes, idx, axis=1)
        active = (t < lens) & (lo < hi) & (c < 4)
        c_safe = jnp.clip(c, 0, 3)
        nlo, nhi = backward_ext(fm, lo, hi, c_safe)
        bad = (t < lens) & (c >= 4)  # ambiguous base kills the match
        lo = jnp.where(active, nlo, jnp.where(bad, 1, lo))
        hi = jnp.where(active, nhi, jnp.where(bad, 1, hi))
        return lo, hi

    rdt = fm.seq_len.dtype
    lo0 = jnp.zeros(B, rdt)
    hi0 = jnp.broadcast_to(n1.astype(rdt), (B,))
    lo, hi = jax.lax.fori_loop(0, W, step, (lo0, hi0))
    empty = (hi <= lo) | (lens == 0)
    return jnp.where(empty, 0, lo), jnp.where(empty, 0, hi)


def fmd_extend_from_occ(fm: FMDevice, k, l, s, o1, o2):
    """FMD backward extension from precomputed occ4 counts.

    ``o1``/``o2`` are conceptual-prefix occ4 counts at ``k`` and
    ``k + s`` (i.e. ``occ4B(fm, k)`` / ``occ4B(fm, k + s)``); the rest of
    bwa's ``bwt_extend`` (is_back=1) is pure vector arithmetic."""
    cnt = o2 - o1
    k4 = (fm.L2[:4] + 1) + o1
    dollar = ((k <= fm.primary) & (fm.primary < k + s)).astype(jnp.int32)
    # l4[c] = l + dollar + sum_{c' > c} cnt[c']
    suffix = jnp.cumsum(cnt[..., ::-1], axis=-1) - cnt[..., ::-1]
    l4 = (l + dollar)[..., None] + suffix[..., ::-1]
    return k4, l4, cnt


def fmd_extend_back(fm: FMDevice, k, l, s, axis: str | None = None):
    """FMD bi-interval backward extension for all 4 codes (batched).

    k, l, s: int32[...]; returns (k4, l4, s4) of shape (..., 4) —
    bi-intervals of c+P for each code c (bwa bwt_extend, is_back=1).
    Both rank queries issue as one fused gather.
    """
    both = occ4B(fm, jnp.concatenate([k.reshape(-1), (k + s).reshape(-1)]), axis)
    n = k.size
    o1 = both[:n].reshape(k.shape + (4,))
    o2 = both[n:].reshape(k.shape + (4,))
    return fmd_extend_from_occ(fm, k, l, s, o1, o2)




def fmd_extend_fwd(fm: FMDevice, k, l, s, axis: str | None = None):
    """FMD forward extension: bi-intervals of P+c for each code c."""
    k4, l4, s4 = fmd_extend_back(fm, l, k, s, axis)
    return l4[..., ::-1], k4[..., ::-1], s4[..., ::-1]


def _sa_marked(fm: FMDevice, r: jnp.ndarray, axis: str | None = None) -> jnp.ndarray:
    """Whether ranks carry a sampled SA value (batched bit lookup).

    The flat mark bitmap makes this ONE word gather: the word covering
    rank r is ``sa_words[r >> 5]`` (FMDevice layout)."""
    w, mine = _table_row(fm.sa_words, r >> 5, axis)
    word = jax.lax.bitcast_convert_type(w, jnp.uint32)
    bit = ((word >> (r & 31).astype(jnp.uint32)) & 1).astype(jnp.int32)
    return _owner_sum(bit, mine, axis).astype(jnp.bool_)


def _sa_slot(fm: FMDevice, r: jnp.ndarray, axis: str | None = None) -> jnp.ndarray:
    """Number of marked ranks before each rank (its sa_sample slot)."""
    r5 = r >> 7
    widx = jnp.arange(4, dtype=jnp.int32)
    wraw, mine_w = _table_row(fm.sa_words, (r5 * 4)[..., None] + widx, axis)
    words = jax.lax.bitcast_convert_type(wraw, jnp.uint32)
    cnt, mine_c = _table_row(fm.sa_cnt, r5, axis)
    w = (r >> 5) & 3
    bits = (r & 31).astype(jnp.uint32)
    # full words before w count entirely; word w counts bits below r&31
    nbits = jnp.where(
        widx < w[..., None], 32, jnp.where(widx == w[..., None], bits[..., None], 0)
    ).astype(jnp.uint32)
    # mask = (1 << nbits) - 1; clamp the shift so the unselected branch
    # never shifts by >= 32 (undefined in XLA)
    mask = jnp.where(nbits >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << jnp.minimum(nbits, 31)) - jnp.uint32(1))
    masked = words & mask
    if mine_w is not None:
        masked = jnp.where(mine_w, masked, 0)
    part = jax.lax.population_count(masked).sum(axis=-1).astype(jnp.int32)
    if axis is not None:
        part = jax.lax.psum(part, axis)
    major = _small_rows(
        fm.sa_majors, jnp.clip(r5 >> _LOG2_MAJOR, 0, fm.sa_majors.shape[0] - 1)
    )
    return part + _owner_sum(cnt, mine_c, axis) + major


def lf_step(fm: FMDevice, r: jnp.ndarray, axis: str | None = None) -> jnp.ndarray:
    """One LF step: rank of the suffix at position SA[r] - 1 (batched).

    One-gather inv_psi: j = r - (r > primary); c = stored[j];
    LF = L2[c] + occ_stored(c, j) + 1; the primary rank wraps to 0."""
    j = r - (r > fm.primary).astype(r.dtype)
    blk = j >> _LOG2_OCC_BLOCK
    off = (j & (OCC_BLOCK - 1)).astype(jnp.int32)
    row, mine = _block_row(fm, blk, axis)
    words = jax.lax.bitcast_convert_type(row[..., 4:], jnp.uint32)
    word = _pick(words, (off >> 4), axis=-1)
    c = ((word >> (2 * (15 - (off & 15))).astype(jnp.uint32)) & 3).astype(jnp.int32)
    ckpt = _pick(row[..., :4], c, axis=-1)
    # the major-checkpoint term rides INSIDE the owner-masked sum: ``c``
    # is decoded from the sharded row (garbage on non-owner shards), so
    # adding _occ_major AFTER the psum would mix every shard's local-c
    # major. Zero-major small indexes masked this for two rounds; the
    # first real (>2^31) sharded run caught it
    # (tools/bigindex_sharded_check.py, round 3).
    lf = _owner_sum(
        _lut(fm.L2, c) + ckpt + _row_counts(row, c, off) + 1
        + _occ_major(fm, blk, c),
        mine, axis)
    return jnp.where(r == fm.primary, 0, lf)


def sa_resolve(fm: FMDevice, ranks: jnp.ndarray, sa_interval: int = 32,
               axis: str | None = None) -> jnp.ndarray:
    """Resolve conceptual ranks to doubled-text positions (batched).

    With position-sampled SA the LF walk is bounded by ``sa_interval - 1``
    steps, so this is a fixed-trip loop with lane masking — no
    data-dependent shapes (SURVEY.md §7).
    """
    r = ranks.astype(fm.sa_sample.dtype)
    steps = jnp.zeros_like(r)

    def body(_, state):
        r, steps = state
        done = _sa_marked(fm, r, axis)
        nxt = lf_step(fm, r, axis)
        r = jnp.where(done, r, nxt)
        steps = jnp.where(done, steps, steps + 1)
        return r, steps

    r, steps = jax.lax.fori_loop(0, sa_interval - 1, body, (r, steps))
    return fm.sa_sample[_sa_slot(fm, r, axis)] + steps


def isa_walk(fm: FMDevice, isa: jnp.ndarray, pos: jnp.ndarray,
             sa_interval: int, do: jnp.ndarray,
             axis: str | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rank of the suffix at doubled-text position ``pos`` (batched).

    The inverse of ``sa_resolve``: anchor at the next position multiple
    of ``sa_interval`` via the sampled inverse suffix array ``isa``
    (isa[m // interval] = rank of the suffix at position m), then LF-walk
    down at most ``sa_interval - 1`` steps (each LF moves one position
    left). Returns (rank, ok); ``ok`` is False where no anchor exists
    (pos within the final partial stripe, anchor > seq_len) — callers
    must fall back to stepwise paths there. Lanes with ``do`` False are
    masked (their gathers are clamped dummies)."""
    v = sa_interval
    p = pos.astype(fm.sa_sample.dtype)
    anchor = ((p + (v - 1)) // v) * v
    ok = do & (anchor <= fm.seq_len) & (p >= 0)
    steps = jnp.where(ok, anchor - p, 0).astype(jnp.int32)
    slot = jnp.clip(anchor // v, 0, isa.shape[0] - 1)
    r = jnp.where(ok, isa[slot], 1)

    def body(t, r):
        return jnp.where((t < steps) & ok, lf_step(fm, r, axis), r)

    r = jax.lax.fori_loop(0, v - 1, body, r)
    return r, ok


def depos(fm: FMDevice, pos: jnp.ndarray, length) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Doubled-text position -> (forward position, is_reverse). Batched."""
    is_rev = pos >= fm.l_pac
    fwd = jnp.where(is_rev, fm.seq_len - pos - length, pos)
    return fwd, is_rev


def rid_of(fm: FMDevice, fwd_pos: jnp.ndarray) -> jnp.ndarray:
    """Reference row index for forward positions (batched searchsorted)."""
    return (
        jnp.searchsorted(fm.ref_offsets, fwd_pos, side="right").astype(jnp.int32) - 1
    )
