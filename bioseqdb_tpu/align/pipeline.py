"""The align(reads, index) pipeline.

Replaces the reference's per-row SQL search loop
(``nuclseq_multi_search_bwa``, extension.cpp:345-378 — one
``mem_align1`` call per SPI row on one core) with a batched device
pipeline: reads stream in rectangular code batches, the whole batch
moves through backward search / SA resolution / coordinate rebase as a
single jitted program, and only the compact hit arrays return to the
host.

Currently implemented mode: exact-match seeding end-to-end
(BASELINE.md config 1). Full SMEM seeding + chaining + banded SW
extension land on top of the same step structure (SURVEY.md §7 stages
4-6).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.align.result import Hit, ReadResult
from bioseqdb_tpu.index.fmindex import FMIndex
from bioseqdb_tpu.io.batch import ReadBatch, pack_reads
from bioseqdb_tpu.kernels import fm as kfm
from bioseqdb_tpu.kernels.extend import sw_kernel_for


@functools.partial(jax.jit, static_argnames=("max_hits", "sa_interval"))
def exact_align_step(fm: kfm.FMDevice, codes, lens, max_hits: int,
                     sa_interval: int = 32):
    """Jitted exact-match alignment of one read batch.

    codes: int32[B, W], lens: int32[B]. Returns per-read hit arrays of
    width ``max_hits``: valid mask, rid, 0-based position within the
    reference, strand, plus the total interval size (for MAPQ/ambiguity).
    """
    codes = codes.astype(jnp.int32)  # uint8 on the wire (see _put_batch)
    lo, hi = kfm.backward_search(fm, codes, lens)
    n_hits = hi - lo
    h = jnp.arange(max_hits, dtype=jnp.int32)[None, :]
    valid = h < jnp.minimum(n_hits, max_hits)[:, None]
    ranks = jnp.where(valid, lo[:, None] + h, 1)  # 1 = safe dummy rank
    pos = kfm.sa_resolve(fm, ranks, sa_interval)
    fwd, rev = kfm.depos(fm, pos, lens[:, None])
    rid = kfm.rid_of(fm, fwd)
    ref_off = fm.ref_offsets[rid]
    ref_len = fm.ref_lens[rid]
    # drop hits bridging two concatenated references (bwa drops these too)
    inside = (fwd >= ref_off) & (fwd + lens[:, None] <= ref_off + ref_len)
    valid = valid & inside
    local = fwd - ref_off
    return dict(n_hits=n_hits, valid=valid, rid=rid, pos=local, rev=rev)


# NOTE deliberately not wrapped in an outer jax.jit: every stage below is
# individually jitted, and wrapping the composition in another jit hits a
# JAX 0.9 executable-cache bug (same-shape re-executions fail with
# "Execution supplied 14 buffers but compiled program expected 16").
def full_align_step(
    fm: kfm.FMDevice, pac_dev, codes, lens, mat,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_occ: int, max_seeds: int, max_chains: int,
    match_score: int, mismatch_penalty: int,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    bandwidth: int, zdrop: int, pen_clip5: int, pen_clip3: int,
    min_chain_weight: int, max_chain_gap: int,
    mask_level: float, chain_drop_ratio: float,
    sa_interval: int = 32,
    sw_kernel: str = "xla",
    keep_mems: bool = False,
    table=None,
    max_cand: int = 0,
    kcand: int = 1,
    sw_mesh=None,
    max_mem: int = 0,
    max_iters: int = 0,
    max_regs: int = 0,
    seeder: str = "fm",
    kmer_table=None,
    kmer_meta=None,
):
    """Jitted full BWA-MEM device pipeline for one batch: SMEM seeding ->
    seed resolution -> chaining -> chain filter -> banded-SW extension.
    Returns candidate regions + the per-read repetitive-coverage length
    (l_rep, for frac_rep); ``keep_mems`` additionally returns the raw
    seed-interval tables (10+ MB at B=8192 — only for tests/debugging,
    the host finalize needs just l_rep)."""
    from bioseqdb_tpu.kernels.chain import (
        chain_seeds, filter_chains, l_rep_device, resolve_seeds)
    from bioseqdb_tpu.kernels.extend import extend_all
    from bioseqdb_tpu.kernels.seed import collect_seeds_device

    # reads ship host->device as uint8; compute in int32. kcand is read
    # from its env var by the NON-traced caller (Aligner.device_regions)
    # and rides in as a static jit arg — reading env inside the trace
    # would capture the first-seen value outside the jit cache key.
    # ``table`` (kernels/seed.py SeedTable) is the unified seeding
    # table's static row map: r3 jump + in-loop fast-forward regions.
    codes = codes.astype(jnp.int32)
    # smaller per-lane tables for short reads: the seeding loop rewrites
    # its whole state every iteration, so table bytes are HBM bandwidth;
    # 150 bp 1%-sub reads measure n_cand <= 16 / n_mem <= 9 (overflow ->
    # host oracle covers the tail exactly). ``max_cand`` override: the
    # per-pass candidate count scales ~log4(genome) (one distinct
    # interval size per depth until s hits 1), so GRCh38-class indexes
    # need 24 where E.coli-class needs 16 — at 16, 91% of GRCh38 reads
    # overflowed to the host oracle (round-2 chip check).
    if codes.shape[1] <= 200:
        caps = dict(max_cand=max_cand or 16, max_mem=max_mem or 16)
    else:
        caps = dict(max_cand=max_cand) if max_cand else {}
        if codes.shape[1] >= 768:
            # long reads carry more seeds: round 3 alone emits ~one per
            # min_seed_len span of unique sequence (bwt_seed_strategy1),
            # so ~W/19 mems for a unique read; cap overflow would route
            # the whole read to the host oracle
            caps["max_mem"] = codes.shape[1] // 16 + 48
        if max_mem:
            caps["max_mem"] = max_mem
    if max_iters:  # fat-cap overflow retry (Aligner.absorb_overflow)
        caps["max_iters"] = max_iters
    # long reads would exceed the kmer path's minimizer/diagonal caps on
    # every lane (~2W/7 selected minimizers vs the 64-slot budget);
    # they keep the FM state machine (short reads are the throughput
    # target — BASELINE configs 2-5)
    if seeder == "kmer" and codes.shape[1] > 320:
        seeder = "fm"
    if seeder == "kmer":
        # minimizer-table seeding (kernels/kmer.py): rounds 1+3 from a
        # handful of independent gathers, round 2 (when not provably
        # empty) on the FM machine's reseed-only entry, hard cases ->
        # overflow (fat FM retry / host oracle).
        from bioseqdb_tpu.kernels import kmer as kkm

        M_k = caps.get("max_mem") or 48
        M_tot = M_k + 8
        nmz = kkm.nmz_for(int(codes.shape[1]))
        ko = kkm.collect_seeds_kmer(
            kmer_table, pac_dev, fm.seq_len, codes, lens,
            bb=kmer_meta.bb, min_seed_len=min_seed_len,
            split_len=split_len, split_width=split_width,
            max_mem_intv=max_mem_intv, smax=kkm.smax_for(max_mem_intv),
            dmax=kkm.dmax_for(kmer_meta, nmz), nmz=nmz,
            max_mem=M_k)
        r2m = collect_seeds_device(
            fm, codes, lens, min_seed_len=min_seed_len,
            split_len=split_len, split_width=split_width,
            max_mem_intv=0,  # machine runs ONLY round 2
            jump_base=0, jump_depth=0, sa_interval=sa_interval, kcand=1,
            max_cand=caps.get("max_cand") or max_cand or 24,
            max_mem=M_tot, entry_reseed=True,
            reseed_entry=dict(mem_s=ko["mem_s"], mem_b=ko["mem_b"],
                              mem_e=ko["mem_e"], n_mem=ko["n_mem"],
                              active=ko["needs_r2"]),
            **({"max_iters": caps["max_iters"]} if "max_iters" in caps
               else {}),
        )
        # assemble: machine output rows [0, n_kmer) are the preloaded
        # kmer mems — overwrite their k column with the POSITION and
        # set the (dead) l column to 1 as the pos-row flag
        # (chain.resolve_seeds); rows beyond carry round-2 rank
        # intervals untouched
        m5 = r2m["mems"]
        rdt = m5.dtype
        isk = (jnp.arange(M_tot, dtype=jnp.int32)[None, :]
               < ko["n_mem"][:, None])
        posk = jnp.pad(ko["mem_pos"].astype(rdt),
                       ((0, 0), (0, M_tot - M_k)))
        mems = dict(
            mems=jnp.stack(
                [jnp.where(isk, posk, m5[:, :, 0]), isk.astype(rdt),
                 m5[:, :, 2], m5[:, :, 3], m5[:, :, 4]], axis=2),
            n_mem=r2m["n_mem"],
            overflow=ko["overflow"] | r2m["overflow"],
        )
    else:
        mems = collect_seeds_device(
            fm, codes, lens, min_seed_len=min_seed_len, split_len=split_len,
            split_width=split_width, max_mem_intv=max_mem_intv,
            jump_base=(table.jump_base if table else 0),
            jump_depth=(table.jump_depth if table else 0),
            sa_interval=sa_interval, kcand=kcand, **caps,
        )
    seeds = resolve_seeds(
        fm, mems["mems"], mems["n_mem"], max_occ=max_occ,
        max_seeds=max_seeds, sa_interval=sa_interval,
        # kmer path: only round-2 rank rows walk the SA (rare lanes);
        # the fixed-trip walk costs by static lane count
        compact_cap=(4096 if seeder == "kmer" else 0))
    chains = chain_seeds(fm, seeds, max_chains=max_chains,
                         bandwidth=bandwidth, max_chain_gap=max_chain_gap)
    flt = filter_chains(chains, seeds, mask_level=mask_level,
                        chain_drop_ratio=chain_drop_ratio,
                        min_chain_weight=min_chain_weight,
                        min_seed_len=min_seed_len,
                        max_chain_gap=max_chain_gap)
    # long-read windowed seed re-scoring (mem_flt_chained_seeds):
    # statically absent for short-read batches (possibly_active False)
    from bioseqdb_tpu.kernels.seedsw import possibly_active, seed_sw_filter

    if (possibly_active(min_chain_weight, int(codes.shape[1]))
            and pac_dev is not None and pac_dev.ndim == 2):
        seeds = seed_sw_filter(
            fm, pac_dev, codes, lens, seeds,
            match_score=match_score, mismatch_penalty=mismatch_penalty,
            o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
            min_chain_weight=min_chain_weight)
    ext = extend_all(
        fm, pac_dev, codes, lens, seeds, chains, flt, mat,
        match_score=match_score, mismatch_penalty=mismatch_penalty,
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        bandwidth=bandwidth, zdrop=zdrop,
        pen_clip5=pen_clip5, pen_clip3=pen_clip3,
        sw_kernel=sw_kernel, sw_mesh=sw_mesh,
        **(dict(max_regs=max_regs) if max_regs else {}),
    )
    overflow = (
        mems["overflow"] | seeds["overflow"] | chains["overflow"]
        | ext["overflow"]
    )
    regs = dict(ext["regs"])
    regs.pop("cchain", None)  # extend-internal; the host never reads it
    out = dict(
        regs=regs, n_regs=ext["n_regs"], overflow=overflow,
        l_rep=l_rep_device(mems["mems"], mems["n_mem"], max_occ=max_occ),
    )
    if keep_mems:
        out["mems"] = mems["mems"]
        out["n_mem"] = mems["n_mem"]
    return out


# fields whose values are bounded by the read width / scoring config, so
# they ship to the host as int16 when the (static) bounds allow
_NARROW_FIELDS = ("qb", "qe", "score", "truesc", "w", "seedlen0", "seedcov")


def pack_codes_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side wire packing of read codes: 2-bit base codes (4/byte)
    plus an ambiguity bitmap (8/byte) — 60 bytes per 150bp read instead
    of 160, which cuts the host->device upload 2.67x. Width pads to a
    multiple of 8 with code 4 (same semantics as pack_reads padding).
    Unpacked on device by ``_unpack_codes``."""
    codes = np.asarray(codes, np.uint8)
    B, W = codes.shape
    Wp = -(-W // 8) * 8
    if Wp != W:
        codes = np.concatenate(
            [codes, np.full((B, Wp - W), 4, np.uint8)], axis=1)
    nm = codes >= 4
    c2 = np.where(nm, 0, codes).reshape(B, Wp // 4, 4)
    u2 = ((c2 << (2 * np.arange(4, dtype=np.uint8))).sum(
        axis=2, dtype=np.uint32)).astype(np.uint8)
    nmb = np.packbits(nm, axis=1, bitorder="little")
    return u2, nmb


def _unpack_codes(u2: jnp.ndarray, nm: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of ``pack_codes_2bit``: (B, W/4) 2-bit words
    + (B, W/8) ambiguity bitmap -> (B, W) uint8 codes 0..4."""
    B, Wq = u2.shape
    shifts = (2 * jnp.arange(4, dtype=jnp.uint8))[None, None, :]
    c = ((u2[:, :, None] >> shifts) & 3).reshape(B, Wq * 4)
    bits = jnp.arange(8, dtype=jnp.uint8)[None, None, :]
    m = ((nm[:, :, None] >> bits) & 1).reshape(B, -1)[:, : Wq * 4]
    return jnp.where(m == 1, jnp.uint8(4), c)


_unpack_codes_jit = jax.jit(_unpack_codes)


def _pack_out(out: dict, cap: int, narrow: bool) -> dict:
    """Row-compact the (B, R) region tables for the device->host hop.

    Mean regions per read is ~1 while R is 8, so the dense tables
    dominate the device->host transfer. Scatter each read's n_regs live
    rows to flat (cap,) arrays at off[i] = exclusive cumsum of counts; reads
    whose rows fall past ``cap`` are detectable on the host as
    off + n_regs > cap and fall back to the host oracle
    (finalize.maybe_unpack) — no information is silently lost."""
    regs = out["regs"]
    R = regs["qb"].shape[1]
    nr = jnp.minimum(out["n_regs"], R)
    off = jnp.cumsum(nr) - nr
    r_i = jnp.arange(R, dtype=jnp.int32)[None, :]
    valid = r_i < nr[:, None]
    dst = jnp.where(valid, off[:, None] + r_i, cap).reshape(-1)

    # group fields by target dtype and scatter each group ONCE as a
    # (B*R, F) row table instead of one scatter per field (chosen on
    # another accelerator, whose scatters cost per row; not measured on
    # the GPU). Columns are split back afterwards, so the wire format
    # (one flat array per field) is unchanged.
    tgt_dtype = {}
    for k, a in regs.items():
        dt = a.dtype
        if narrow and k in _NARROW_FIELDS and dt == jnp.int32:
            dt = jnp.dtype(jnp.int16)
        tgt_dtype[k] = dt
    packed = {}
    for dt in sorted({str(d) for d in tgt_dtype.values()}):
        keys = [k for k, d in tgt_dtype.items() if str(d) == dt]
        mat = jnp.stack(
            [regs[k].astype(tgt_dtype[k]).reshape(-1) for k in keys],
            axis=1)
        tab = jnp.zeros((cap, len(keys)), mat.dtype).at[dst].set(
            mat, mode="drop")
        for i, k in enumerate(keys):
            packed[k] = tab[:, i]

    out = dict(out)
    out["regs"] = packed
    out["off"] = off.astype(jnp.int32)
    return out


_pack_out_jit = functools.partial(jax.jit(_pack_out,
                                          static_argnames=("cap", "narrow")))

_STEP_STATICS = (
    "min_seed_len", "split_len", "split_width", "max_mem_intv", "max_occ",
    "max_seeds", "max_chains", "match_score", "mismatch_penalty",
    "o_del", "e_del", "o_ins", "e_ins", "bandwidth", "zdrop",
    "pen_clip5", "pen_clip3", "min_chain_weight", "max_chain_gap",
    "mask_level", "chain_drop_ratio", "sa_interval", "sw_kernel",
    "keep_mems", "table", "pack_cap", "pack_narrow",
    "max_cand", "kcand", "sw_mesh", "max_mem", "max_iters", "max_regs",
    "seeder", "kmer_meta",
)


@functools.partial(jax.jit, static_argnames=_STEP_STATICS)
def _pair_align_step_jit(fm, pac_dev, codes, lens, mat,
                         pack_cap: int = 0, pack_narrow: bool = False, **kw):
    """Fused paired-end step: BOTH mates ride ONE compiled program.

    ``codes`` is the row-concatenation [mates1; mates2] (2B rows). The
    device pipeline runs once at 2B, then the two halves pack
    separately so the host sees the same two per-mate dicts the
    unfused path produced. One dispatch per pair batch instead of two."""
    if isinstance(codes, tuple):  # wire-packed (pack_codes_2bit)
        codes = _unpack_codes(*codes)
    out = full_align_step(fm, pac_dev, codes, lens, mat, **kw)
    B = codes.shape[0] // 2

    def half(lo):
        sl = lambda v: v[lo : lo + B]
        h = {k: ({kk: sl(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else sl(v))
             for k, v in out.items()}
        return _pack_out(h, pack_cap, pack_narrow) if pack_cap else h

    return half(0), half(B)


@functools.partial(jax.jit, static_argnames=_STEP_STATICS)
def _full_align_step_jit(fm, pac_dev, codes, lens, mat,
                         pack_cap: int = 0, pack_narrow: bool = False, **kw):
    """full_align_step + output packing as ONE compiled program.

    The composed (per-stage-jitted) form costs ~7 dispatches per batch;
    one program is one dispatch. The "Execution supplied N buffers but
    compiled program expected M" crash that originally forced the
    per-stage form was OUR bug, not JAX's: module-level jnp scalars
    (kernels NEG constants) became leaked tracers when their module was
    first imported under an active trace — fixed by keeping them plain
    Python ints. BST_NO_ONEJIT=1 falls back to per-stage dispatch."""
    if isinstance(codes, tuple):  # wire-packed (pack_codes_2bit)
        codes = _unpack_codes(*codes)
    out = full_align_step(fm, pac_dev, codes, lens, mat, **kw)
    if pack_cap:
        out = _pack_out(out, pack_cap, pack_narrow)
    return out


@dataclass
class Aligner:
    """Bound (index, options) ready to align read batches.

    The analogue of a built ``BwaIndex`` + applied ``bwa_options``
    (extension.cpp:211-236) — except the index is built once and reused,
    not rebuilt per call. ``mode`` selects the exact-match fast path or
    the full BWA-MEM pipeline (device seeding/chaining/extension + host
    finalization)."""

    index: FMIndex
    options: AlignOptions
    fm: kfm.FMDevice
    mode: str = "full"
    pac_dev: object = None
    mesh: object = None
    fms: object = None    # FMSharded when the mesh has an "index" axis
    table: object = None  # SeedTable: unified seeding-table row map
    kmer_table: object = None  # kernels/kmer.py KmerTable (device arrays)
    kmer_meta: object = None   # KmerMeta (static) — None = FM seeder

    @classmethod
    def build(cls, index: FMIndex, options: AlignOptions | None = None,
              device=None, mode: str = "full", mesh=None) -> "Aligner":
        """Bind an index for alignment.

        With a ``mesh`` whose only axis is ``data`` (1-D), the index
        replicates to every device and batches shard data-parallel
        along the batch axis (SURVEY.md §2b). With an ``index`` axis
        present (e.g. a 2-D (data, index) mesh), the rank tables shard
        by BWT-interval row range across it and the full pipeline runs
        under shard_map (dist/shard_index.py) — the human-scale layout."""
        if mesh is not None and "index" in getattr(mesh, "axis_names", ()):
            if mode != "full":
                raise ValueError("index-sharded meshes support mode='full'")
            from bioseqdb_tpu.dist.shard_index import shard_index

            return cls(
                index=index, options=options or AlignOptions(), fm=None,
                mode=mode, pac_dev=None, mesh=mesh,
                fms=shard_index(index, mesh),
            )
        if mesh is not None:
            from bioseqdb_tpu.dist.mesh import replicated

            device = replicated(mesh)
        fm = kfm.FMDevice.from_host(index, device=device)
        table = None
        if mode == "full":
            from bioseqdb_tpu.kernels.extend import pack_doubled_rows
            from bioseqdb_tpu.kernels.seed import build_seed_table

            pac_dev = jax.device_put(
                jnp.asarray(index.packed_doubled_rows(pack_doubled_rows)),
                device)
            # seeding table: r3 jump rows appended to fm.blocks
            # (kernels/seed.py build_seed_table). BST_NO_R3_JUMP=1
            # disables the jump; BST_JUMP_DEPTH forces a depth
            # (gather-cliff A/Bs).
            force_d = None
            if os.environ.get("BST_NO_R3_JUMP") == "1":
                force_d = 0
            elif os.environ.get("BST_JUMP_DEPTH"):
                force_d = int(os.environ["BST_JUMP_DEPTH"])
            fm, table = build_seed_table(fm, index, depth=force_d)
        else:
            pac_dev = None
        kmer_table = kmer_meta = None
        opts = options or AlignOptions()
        if mode == "full":
            # minimizer seeding table (kernels/kmer.py): default path
            # when the index/options are parity-eligible; BST_SEEDER=fm
            # keeps the FM state machine
            from bioseqdb_tpu.kernels import kmer as kkm

            want = os.environ.get("BST_SEEDER", "auto")
            if want in ("auto", "kmer") and kkm.kmer_eligible(index, opts):
                host, kmer_meta = index.kmer_table_arrays(kkm.build_kmer_table)
                kmer_table = kkm.KmerTable(
                    bmeta=jax.device_put(jnp.asarray(host["bmeta"]), device),
                    entries=jax.device_put(jnp.asarray(host["entries"]),
                                           device),
                )
        return cls(
            index=index,
            options=opts,
            fm=fm,
            mode=mode,
            pac_dev=pac_dev,
            mesh=mesh,
            table=table,
            kmer_table=kmer_table,
            kmer_meta=kmer_meta,
        )

    def _put_batch(self, batch: ReadBatch):
        # codes stay uint8 on the wire (4x less host->device transfer);
        # kernels cast to int32 on device
        codes = np.asarray(batch.codes, np.uint8)
        lens = np.asarray(batch.lens, np.int32)
        if self.mesh is None:
            return jnp.asarray(codes), jnp.asarray(lens)
        from jax.sharding import NamedSharding, PartitionSpec as P

        names = self.mesh.axis_names
        d = self.mesh.shape["data"] if "data" in names else 1
        rows = ((codes.shape[0] + d - 1) // d) * d
        if rows != codes.shape[0]:
            pad = rows - codes.shape[0]
            codes = np.concatenate(
                [codes, np.full((pad, codes.shape[1]), 4, np.uint8)]
            )
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        sh = NamedSharding(self.mesh, P("data") if "data" in names else P())
        return jax.device_put(codes, sh), jax.device_put(lens, sh)

    def align_batch(self, batch: ReadBatch, max_hits: int | None = None,
                    with_query_ids: bool = True) -> list[ReadResult]:
        """Align a packed batch; returns per-read results.

        mode="exact" only reports full-length exact matches (reads with
        any mismatch/indel/clip come back unmapped — use mode="full"
        for BWA-MEM semantics), but its records are FIELD-COMPLETE for
        what it reports: CIGAR/NM/MD/AS by construction, and MAPQ/XS
        as the bwa formula's exact outcome for a full-length exact
        match (60-or-0 / repeat-score-or-0 — see _to_results). The one
        residual deviation: XS:i:0 on a unique exact hit even when an
        INEXACT near-best alignment exists that full mode would report
        as the sub-optimal score."""
        if self.mode == "exact":
            if max_hits is None:
                max_hits = min(self.options.resolve_max_occ(self.index.n_refs), 64)
            codes, lens = self._put_batch(batch)
            out = exact_align_step(self.fm, codes, lens, max_hits,
                                   sa_interval=self.index.sa_interval)
            return self._to_results(batch, jax.device_get(out), with_query_ids)
        return self._align_full(batch, with_query_ids)

    def device_regions(self, batch: ReadBatch, keep_mems: bool = False,
                       pack: bool | None = None):
        """Run the device pipeline only (no host finalize); returns the
        raw region arrays (+ seed-interval tables with ``keep_mems``).
        Used by benchmarks and the finalizer.

        ``pack`` (default: on, except for keep_mems/sharded runs)
        row-compacts the region tables for the device->host transfer
        (_pack_out); finalize.maybe_unpack restores the dense layout."""
        from bioseqdb_tpu.cpu.ksw import fill_scmat

        opt = self.options
        mat = jnp.asarray(
            fill_scmat(opt.match_score, opt.mismatch_penalty).astype(np.int32)
        )
        if self.fms is not None:
            from bioseqdb_tpu.dist.shard_index import full_align_step_sharded

            codes, lens = self._put_batch(batch)
            data_axis = "data" if "data" in self.mesh.axis_names else None
            return full_align_step_sharded(
                self.fms, codes, lens, mat, self.mesh, opt,
                self.index.n_refs, data_axis=data_axis,
                sa_interval=self.index.sa_interval, keep_mems=keep_mems,
                max_cand=(24 if self.index.seq_len >= (1 << 31) else 0),
                sw_kernel=sw_kernel_for(self.platform()),
            )
        if pack is None:
            pack = not keep_mems
        if self.mesh is None:
            # replace the uint8 codes upload with the 2.67x smaller
            # 2-bit + ambiguity-bitmap wire form; the jit wrapper unpacks
            u2, nmb = pack_codes_2bit(np.asarray(batch.codes, np.uint8))
            codes = (jnp.asarray(u2), jnp.asarray(nmb))
            lens = jnp.asarray(np.asarray(batch.lens, np.int32))
            B = int(u2.shape[0])
            W = int(u2.shape[1]) * 4
        else:
            codes, lens = self._put_batch(batch)
            B = int(codes.shape[0])
            W = int(codes.shape[1])
        common, narrow = self._step_kwargs(W, keep_mems)
        # mean regions/read is ~1.007 on short-read workloads, so a
        # 1.25x cap more than covers every observed batch while halving
        # the device->host row-table bytes vs a 2x cap; reads packed
        # past the cap are detected host-side and fall back to the
        # oracle (maybe_unpack)
        cap = (5 * B) // 4 if pack else 0
        if os.environ.get("BST_NO_ONEJIT") == "1":
            if isinstance(codes, tuple):
                codes = _unpack_codes_jit(*codes)
            out = full_align_step(self.fm, self.pac_dev, codes, lens, mat,
                                  **common)
            return _pack_out_jit(out, cap=cap, narrow=narrow) if pack else out
        return _full_align_step_jit(self.fm, self.pac_dev, codes, lens, mat,
                                    pack_cap=cap, pack_narrow=narrow,
                                    **common)

    def _step_kwargs(self, W: int, keep_mems: bool = False):
        """The static device-step kwargs shared by the SE and fused-PE
        entry points; returns (common, narrow)."""
        opt = self.options
        split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
        narrow = (W * max(int(opt.match_score), 1) < 30000
                  and int(opt.bandwidth) * 16 < 30000 and W < 30000)
        common = dict(
            min_seed_len=opt.min_seed_len, split_len=split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_occ=opt.resolve_max_occ(self.index.n_refs),
            # long reads resolve more located seeds/chains (a 1-3 kb
            # batch must finalize on device; round 3 emits ~W/19 seeds
            # on unique sequence)
            max_seeds=64 if W <= 512 else W // 12 + 64,
            max_chains=16 if W <= 512 else 32,
            match_score=opt.match_score, mismatch_penalty=opt.mismatch_penalty,
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
            bandwidth=opt.bandwidth, zdrop=opt.zdrop,
            pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
            min_chain_weight=opt.min_chain_weight,
            max_chain_gap=opt.max_chain_gap,
            mask_level=opt.mask_level, chain_drop_ratio=opt.chain_drop_ratio,
            sa_interval=self.index.sa_interval, keep_mems=keep_mems,
            table=self.table,
            # candidate stack scales with log4(genome); see full_align_step
            max_cand=(24 if self.index.seq_len >= (1 << 31) else 0),
            **self._sw_kwargs(),
        )
        # env-var tunables become STATIC jit args here, in non-traced
        # code, so toggling them mid-process retraces instead of being
        # silently ignored
        common.update(
            kcand=int(os.environ.get("BST_KCAND", "1")),
            seeder=("kmer" if self.kmer_meta is not None else "fm"),
            kmer_table=self.kmer_table,
            kmer_meta=self.kmer_meta,
        )
        return common, narrow

    def platform(self) -> str:
        """JAX platform of the devices holding this aligner's index."""
        tab = self.fms.blocks if self.fms is not None else self.fm.blocks
        return next(iter(tab.devices())).platform

    def _sw_kwargs(self) -> dict:
        """Banded-SW settings: the kernel for the index's platform, and
        the 1-D data mesh (if any) that runs it per shard."""
        return dict(sw_kernel=sw_kernel_for(self.platform()),
                    sw_mesh=self.mesh if self.fms is None else None)

    def device_regions_pair(self, batch1: ReadBatch, batch2: ReadBatch):
        """Run BOTH mates of a pair batch through ONE device dispatch
        (_pair_align_step_jit): mates concatenate row-wise (padded to a
        common width), the pipeline runs once at 2B, and the halves
        pack separately. Returns (out1, out2) shaped exactly like two
        ``device_regions`` results. Falls back to two dispatches under
        an index-sharded mesh (the shard_map path has its own batch
        plumbing)."""
        if self.fms is not None or self.mesh is not None:
            return (self.device_regions(batch1), self.device_regions(batch2))
        from bioseqdb_tpu.cpu.ksw import fill_scmat

        opt = self.options
        mat = jnp.asarray(
            fill_scmat(opt.match_score, opt.mismatch_penalty).astype(np.int32)
        )
        c1, c2 = np.asarray(batch1.codes), np.asarray(batch2.codes)
        W = max(c1.shape[1], c2.shape[1])
        B = c1.shape[0]
        padW = lambda c: np.concatenate(
            [c, np.full((c.shape[0], W - c.shape[1]), 4, c.dtype)], axis=1
        ) if c.shape[1] < W else c
        codes = np.concatenate([padW(c1), padW(c2)]).astype(np.uint8)
        lens = np.concatenate([batch1.lens, batch2.lens]).astype(np.int32)
        # 2-bit + ambiguity-bitmap wire form (see device_regions)
        u2, nmb = pack_codes_2bit(codes)
        W = int(u2.shape[1]) * 4
        common, narrow = self._step_kwargs(W)
        cap = (5 * B) // 4  # per-mate pack cap (matches device_regions)
        return _pair_align_step_jit(
            self.fm, self.pac_dev, (jnp.asarray(u2), jnp.asarray(nmb)),
            jnp.asarray(lens), mat, pack_cap=cap, pack_narrow=narrow,
            **common)

    # overflow-retry cap schedule: row buckets bound the number of
    # distinct compiled fat programs; the cap multipliers cover every
    # overflow source (candidate stack, mems table, located seeds,
    # chains, region slots, per-lane iteration budget)
    RETRY_BUCKETS = (64, 256, 1024)

    def _retry_eligible(self, out: dict) -> bool:
        return (self.mode == "full" and self.mesh is None
                and self.fms is None and "mems" not in out)

    def _fat_retry(self, codes_sel: np.ndarray, lens_sel: np.ndarray) -> dict:
        """One fat-cap dispatch over the selected overflow rows (padded
        to a RETRY_BUCKETS row bucket); returns the device-get result."""
        from bioseqdb_tpu.cpu.ksw import fill_scmat

        k, W = codes_sel.shape
        bucket = next(b for b in self.RETRY_BUCKETS if b >= k)
        codes = np.full((bucket, W), 4, np.uint8)
        codes[:k] = codes_sel
        lens = np.zeros(bucket, np.int32)
        lens[:k] = lens_sel
        opt = self.options
        mat = jnp.asarray(
            fill_scmat(opt.match_score, opt.mismatch_penalty).astype(np.int32))
        common, _ = self._step_kwargs(W)
        common.update(
            max_cand=32, max_mem=32,
            max_seeds=max(2 * common["max_seeds"], 128),
            max_chains=2 * common["max_chains"],
            max_iters=3 * (10 * W + 256), max_regs=16,
            # retried rows are exactly the ones the kmer fast path
            # could not hold exact — the retry must run the FM seeder
            seeder="fm", kmer_table=None, kmer_meta=None,
        )
        return jax.device_get(_full_align_step_jit(
            self.fm, self.pac_dev, jnp.asarray(codes), jnp.asarray(lens),
            mat, **common))

    @staticmethod
    def _splice_retry(out: dict, ovf: np.ndarray, r: dict, base: int) -> dict:
        """Write retry rows r[base : base + len(ovf)] back into the
        dense out tables (growing R when the fat program's region slots
        exceed the original)."""
        k = ovf.size
        R_old = next(iter(out["regs"].values())).shape[1]
        R_new = next(iter(r["regs"].values())).shape[1]
        regs = {}
        for key, a in out["regs"].items():
            a = np.asarray(a)
            if R_new > R_old:
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], R_new - R_old), a.dtype)],
                    axis=1)
            else:
                a = a.copy()  # never mutate the caller's arrays
            a[ovf] = np.asarray(r["regs"][key])[base : base + k].astype(a.dtype)
            regs[key] = a
        out = dict(out, regs=regs)
        for key in ("n_regs", "overflow", "l_rep"):
            if out.get(key) is not None:
                col = np.asarray(out[key]).copy()
                col[ovf] = np.asarray(r[key])[base : base + k]
                out[key] = col
        return out

    def absorb_overflow(self, batch: ReadBatch, out: dict) -> dict:
        """Re-run overflow rows on DEVICE with fat caps before the host
        oracle sees them.

        The host oracle costs ~100 ms/read at chr20 scale (64 Mb,
        measured round 4) — a 0.25% overflow rate makes it the whole
        batch cost. A second compiled program with doubled caps and a
        3x iteration budget resolves almost all cap overflows in a few
        ms of device time; only rows that STILL overflow fall back to
        the oracle. Returns the (unpacked) out dict with retried rows
        spliced in. No-op under meshes (sharded paths keep their own
        batch plumbing) and when nothing overflowed."""
        from bioseqdb_tpu.align.finalize import maybe_unpack

        if not self._retry_eligible(out):
            return out
        out = maybe_unpack(out)
        n = len(batch.names)
        ovf = np.flatnonzero(np.asarray(out["overflow"])[:n])
        if ovf.size == 0 or ovf.size > self.RETRY_BUCKETS[-1]:
            return out
        r = self._fat_retry(np.asarray(batch.codes, np.uint8)[ovf],
                            np.asarray(batch.lens, np.int32)[ovf])
        return self._splice_retry(out, ovf, r, 0)

    def absorb_overflow_pair(self, batch1: ReadBatch, out1: dict,
                             batch2: ReadBatch, out2: dict):
        """absorb_overflow for a pair batch: BOTH mates' overflow rows
        ride ONE fat dispatch instead of two."""
        from bioseqdb_tpu.align.finalize import maybe_unpack

        if not (self._retry_eligible(out1) and self._retry_eligible(out2)):
            return out1, out2
        out1 = maybe_unpack(out1)
        out2 = maybe_unpack(out2)
        o1 = np.flatnonzero(
            np.asarray(out1["overflow"])[: len(batch1.names)])
        o2 = np.flatnonzero(
            np.asarray(out2["overflow"])[: len(batch2.names)])
        total = o1.size + o2.size
        if total == 0 or total > self.RETRY_BUCKETS[-1]:
            return out1, out2
        c1 = np.asarray(batch1.codes, np.uint8)[o1]
        c2 = np.asarray(batch2.codes, np.uint8)[o2]
        W = max(c1.shape[1] if o1.size else 0, c2.shape[1] if o2.size else 0)
        padW = lambda c: np.concatenate(
            [c, np.full((c.shape[0], W - c.shape[1]), 4, np.uint8)], axis=1
        ) if c.shape[1] < W else c
        codes = np.concatenate([padW(c1), padW(c2)]) if o1.size and o2.size \
            else (padW(c1) if o1.size else padW(c2))
        lens = np.concatenate([np.asarray(batch1.lens, np.int32)[o1],
                               np.asarray(batch2.lens, np.int32)[o2]])
        r = self._fat_retry(codes, lens)
        if o1.size:
            out1 = self._splice_retry(out1, o1, r, 0)
        if o2.size:
            out2 = self._splice_retry(out2, o2, r, o1.size)
        return out1, out2

    def _align_full(self, batch: ReadBatch, with_query_ids: bool) -> list[ReadResult]:
        # long reads (>= ~900 bp: mem_flt_chained_seeds territory) run
        # the device pipeline like any others — the windowed seed-SW
        # filter is a device stage (kernels/seedsw.py); only per-read
        # cap overflows (surviving the absorb_overflow fat-cap retry)
        # fall back to the host oracle
        from bioseqdb_tpu.align.finalize import finalize_batch

        out = jax.device_get(self.device_regions(batch))
        out = self.absorb_overflow(batch, out)
        return finalize_batch(
            self.index, self.options, batch, out, with_query_ids
        )

    def align_pairs(self, batch1: ReadBatch, batch2: ReadBatch):
        """Paired-end alignment of two read batches (ends of the same
        templates, row-aligned). Returns [(ReadResult, ReadResult)] with
        PE flags/mate info attached (align/paired.py)."""
        if self.mode != "full":
            raise ValueError("paired-end alignment requires mode='full'")
        from bioseqdb_tpu.align.paired import finalize_pairs

        o1, o2 = self.device_regions_pair(batch1, batch2)
        out1, out2 = jax.device_get(o1), jax.device_get(o2)
        out1, out2 = self.absorb_overflow_pair(batch1, out1, batch2, out2)
        return finalize_pairs(
            self.index, self.options, batch1, out1, batch2, out2
        )

    def align_pairs_columns(self, batch1: ReadBatch, batch2: ReadBatch):
        """Columnar paired-end alignment (the PE throughput path):
        returns (AlignColumns, AlignColumns) with PE columns attached —
        render with sam.emit.emit_sam_pair_columns. Exactly equal to
        align_pairs (align/paired.py finalize_pairs_columns)."""
        if self.mode != "full":
            raise ValueError("paired-end alignment requires mode='full'")
        from bioseqdb_tpu.align.paired import finalize_pairs_columns

        o1, o2 = self.device_regions_pair(batch1, batch2)
        out1, out2 = jax.device_get(o1), jax.device_get(o2)
        out1, out2 = self.absorb_overflow_pair(batch1, out1, batch2, out2)
        return finalize_pairs_columns(
            self.index, self.options, batch1, out1, batch2, out2
        )

    def _to_results(self, batch: ReadBatch, out: dict,
                    with_query_ids: bool) -> list[ReadResult]:
        idx = self.index
        results: list[ReadResult] = []
        m = int(self.options.match_score)
        for i, name in enumerate(batch.names):
            L = int(batch.lens[i])
            hits: list[Hit] = []
            order = np.flatnonzero(out["valid"][i])
            n_hits = int(out["n_hits"][i])
            for j_rank, j in enumerate(order):
                rid = int(out["rid"][i, j])
                begin = int(out["pos"][i, j])
                hits.append(
                    Hit(
                        ref_id=int(idx.ref_ids[rid]) if len(idx.ref_ids) else rid,
                        ref_name=idx.ref_names[rid],
                        ref_begin=begin,
                        ref_end=begin + L,
                        query_id=i if with_query_ids else None,
                        query_name=name,
                        query_begin=0,
                        query_end=L,
                        is_primary=j_rank == 0,
                        is_secondary=j_rank != 0,
                        is_reverse=bool(out["rev"][i, j]),
                        cigar=f"{L}M",
                        score=m * L,
                        # the bwa MAPQ formula's EXACT outcome for a
                        # full-length exact match: unique -> the raw
                        # 6.02*(score-sub)/a*tmp^2 value clips to 60 for
                        # any L >= ~25bp; repeated -> sub == score -> 0
                        # (mem_approx_mapq_se; same rule fast_fields
                        # applies in full mode)
                        mapq=(60 if n_hits == 1 else 0) if j_rank == 0 else 0,
                        nm=0,                      # exact: no edits
                        md=str(L),                 # MD of an all-match run
                        # XS mirrors full mode: equal-score repeat -> the
                        # repeat's score; unique -> 0 (XS only on the
                        # primary record, like mem_aln2sam)
                        sub=(m * L if n_hits > 1 else 0) if j_rank == 0
                        else -1,
                        rid=rid,
                    )
                )
            results.append(ReadResult(query_name=name, hits=hits))
        return results


def align(reads, index: FMIndex, options: AlignOptions | None = None,
          max_hits: int | None = None) -> list[ReadResult]:
    """One-shot convenience: align sequences/ReadBatch against an index."""
    if not isinstance(reads, ReadBatch):
        reads = pack_reads(list(reads))
    return Aligner.build(index, options).align_batch(reads, max_hits=max_hits)
