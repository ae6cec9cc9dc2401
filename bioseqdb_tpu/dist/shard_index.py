"""BWT-interval-sharded FM-index (human-scale references).

The replicated-index layout caps at one device's HBM; GRCh38's doubled
text does not fit (SURVEY.md §7 "32-bit limits", BASELINE configs 4-5).
This module shards the three position/rank-indexed tables — the
interleaved Occ/BWT ``blocks``, the SA-mark bit-rank ``sa_bits``, and
the forward ``pac`` codes — across an ``index`` mesh axis by row range
("BWT interval"), keeping the small arrays (C counts, sampled SA
values, annotations) replicated.

Rank queries run under ``shard_map`` through the same kernels as the
replicated path (kernels/fm.py with ``axis=...``): every device answers
each query against its local row range (out-of-range rows contribute
zero) and a ``psum`` over the index axis selects the owner — each rank
is owned by exactly one shard, so the sum *is* the value. One
collective of a few ints per lane per step crosses the interconnect; the tables
never move.

``full_align_step_sharded`` runs the ENTIRE device pipeline (seeding,
resolution, chaining, filtering, SW extension) over a 2-D
(data x index) mesh: reads shard along ``data``, tables along
``index``; chaining/filter/SW are data-local, only the FM/pac lookups
collect over ``index``.

Rank values follow the index scale (shard_index auto-selects): int32
below 2^31 doubled bases, int64 beyond (requires jax x64) — the packed
tables stay int32 at any scale via the relative minor checkpoints, so
GRCh38's 6.2G doubled bases shard with unchanged per-device HBM
(tests/test_shard_index.py exercises the forced-int64 path end to end).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bioseqdb_tpu.index.fmindex import FMIndex
from bioseqdb_tpu.kernels import fm as kfm


class FMSharded(NamedTuple):
    """FM-index with rank tables split by row range across ``index``.

    Device layouts follow kernels/fm.py FMDevice (octo block rows, flat
    SA-mark arrays)."""

    L2: jnp.ndarray            # (5,) replicated
    primary: jnp.ndarray       # () replicated
    blocks: jnp.ndarray        # (n_shards, rows_per_shard/8, 128) P(index)
    sa_cnt: jnp.ndarray        # (n_shards, rows2_per_shard) P(index)
    sa_words: jnp.ndarray      # (n_shards, rows2_per_shard*4) P(index)
    sa_sample: jnp.ndarray     # replicated
    occ_majors: jnp.ndarray    # replicated (tiny)
    sa_majors: jnp.ndarray     # replicated (tiny)
    pac: jnp.ndarray           # (n_shards, bases_per_shard) int8 P(index)
    ref_offsets: jnp.ndarray   # replicated
    ref_lens: jnp.ndarray      # replicated
    l_pac: jnp.ndarray
    seq_len: jnp.ndarray


def shard_index(idx: FMIndex, mesh: Mesh, axis: str = "index",
                rank_dtype=None) -> FMSharded:
    """Shard an index's rank tables across ``axis``.

    Rank-VALUED arrays (L2, sampled SA, majors, annotations, lengths)
    follow the index scale like the replicated path (FMDevice.from_host):
    int32 below 2^31 doubled bases, int64 beyond (requires jax x64) —
    the packed tables stay int32 at any scale via the relative minor
    checkpoints, so sharded HBM per device is unchanged."""
    n_sh = mesh.shape[axis]
    if rank_dtype is None:
        rank_dtype = jnp.int64 if idx.seq_len + 1 >= 2**31 else jnp.int32
    if rank_dtype == jnp.int64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "index exceeds int32 rank range; enable x64 (jax.enable_x64) "
            "to run it sharded on device"
        )

    def split(arr, align: int = 1):
        rows = arr.shape[0]
        # shard boundaries must not bisect an octo block row (align=8
        # for the Occ table)
        rps = ((rows + n_sh - 1) // n_sh + align - 1) & ~(align - 1)
        pad = n_sh * rps - rows
        shape = (rows + pad,) + arr.shape[1:]
        out = np.zeros(shape, arr.dtype)
        out[:rows] = arr
        return out.reshape((n_sh, rps) + arr.shape[1:])

    sharded = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    put_s = lambda x, dt: jax.device_put(jnp.asarray(x, dt), sharded)
    put_r = lambda x: jax.device_put(
        jnp.asarray(np.asarray(x), rank_dtype), repl)
    blocks_sh = split(np.asarray(idx.blocks), align=kfm.OCT_BLOCKS)
    sa_sh = split(np.asarray(idx.sa_bits))
    # 128-int32 octo rows per shard (pack_oct layout; the mark columns
    # stay ZERO here — the in-loop fast-forward is replicated-path only,
    # sharded rank walks use the flat sa_cnt/sa_words tables — but the
    # row layout must match kernels/fm.py's 128-wide decoders)
    blocks_oct = np.stack([kfm.pack_oct(blocks_sh[s]) for s in range(n_sh)])
    return FMSharded(
        L2=put_r(idx.L2),
        primary=put_r(idx.primary),
        blocks=put_s(blocks_oct, jnp.int32),
        sa_cnt=put_s(np.ascontiguousarray(sa_sh[:, :, 0]), jnp.int32),
        sa_words=put_s(
            np.ascontiguousarray(sa_sh[:, :, 1:]).reshape(n_sh, -1),
            jnp.int32),
        sa_sample=put_r(idx.sa_sample),
        occ_majors=put_r(idx.occ_majors),
        sa_majors=put_r(idx.sa_majors),
        pac=put_s(split(np.asarray(idx.pac)), jnp.int8),
        ref_offsets=put_r(idx.ref_offsets),
        ref_lens=put_r(idx.ref_lens),
        l_pac=put_r(idx.l_pac),
        seq_len=put_r(idx.seq_len),
    )


def _local_fm(fms: FMSharded) -> kfm.FMDevice:
    """The shard-local FMDevice view used inside shard_map (leading
    shard dim of the sharded tables is 1 locally)."""
    return kfm.FMDevice(
        L2=fms.L2, primary=fms.primary, blocks=fms.blocks[0],
        sa_sample=fms.sa_sample, sa_cnt=fms.sa_cnt[0],
        sa_words=fms.sa_words[0],
        occ_majors=fms.occ_majors, sa_majors=fms.sa_majors,
        ref_offsets=fms.ref_offsets, ref_lens=fms.ref_lens,
        l_pac=fms.l_pac, seq_len=fms.seq_len,
    )


def _in_specs(mesh, axis, data_axis=None, n_batch=0):
    table = P(axis)
    rep = P()
    batch = P(data_axis) if data_axis else P()
    fm_specs = FMSharded(
        L2=rep, primary=rep, blocks=table, sa_cnt=table, sa_words=table,
        sa_sample=rep, occ_majors=rep, sa_majors=rep,
        pac=table, ref_offsets=rep, ref_lens=rep, l_pac=rep, seq_len=rep,
    )
    return (fm_specs,) + (batch,) * n_batch


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def backward_search_sharded(fms: FMSharded, codes, lens, mesh: Mesh,
                            axis: str = "index"):
    """Exact-match intervals with the Occ table sharded by BWT interval.
    Reads replicated across the index axis; results replicated."""

    def inner(fms_l, codes, lens):
        fm = _local_fm(fms_l)
        B, W = codes.shape

        def step(t, state):
            lo, hi = state
            idx = jnp.clip(lens - 1 - t, 0, W - 1)
            c = jnp.take_along_axis(codes, idx[:, None], axis=1)[:, 0]
            active = (t < lens) & (lo < hi) & (c < 4)
            c_safe = jnp.clip(c, 0, 3)
            nlo, nhi = kfm.backward_ext(fm, lo, hi, c_safe, axis=axis)
            bad = (t < lens) & (c >= 4)
            lo = jnp.where(active, nlo, jnp.where(bad, 1, lo))
            hi = jnp.where(active, nhi, jnp.where(bad, 1, hi))
            return lo, hi

        rdt = fm.seq_len.dtype
        lo0 = jnp.zeros(B, rdt)
        hi0 = jnp.broadcast_to(fm.seq_len + 1, (B,)).astype(rdt)
        lo, hi = jax.lax.fori_loop(0, W, step, (lo0, hi0))
        empty = (hi <= lo) | (lens == 0)
        return jnp.where(empty, 0, lo), jnp.where(empty, 0, hi)

    return jax.shard_map(
        inner, mesh=mesh,
        in_specs=_in_specs(mesh, axis, None, 2),
        out_specs=(P(), P()),
        check_vma=False,
    )(fms, codes, lens)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "sa_interval"))
def sa_resolve_sharded(fms: FMSharded, ranks, mesh: Mesh, axis: str = "index",
                       sa_interval: int = 32):
    """Position-sampled SA resolution with sharded rank tables."""

    def inner(fms_l, ranks):
        return kfm.sa_resolve(_local_fm(fms_l), ranks, sa_interval, axis=axis)

    return jax.shard_map(
        inner, mesh=mesh,
        in_specs=_in_specs(mesh, axis, None, 1),
        out_specs=P(),
        check_vma=False,
    )(fms, ranks)


def full_align_step_sharded(
    fms: FMSharded, codes, lens, mat, mesh: Mesh, opt, n_refs: int,
    axis: str = "index", data_axis: str | None = None,
    max_seeds: int = 64, max_chains: int = 16, sa_interval: int = 32,
    keep_mems: bool = False, max_cand: int = 0, sw_kernel: str = "xla",
):
    """The full device pipeline over a (data x index) mesh: reads shard
    along ``data`` (if the mesh has that axis), tables along ``index``.
    Same outputs as pipeline.full_align_step."""
    from bioseqdb_tpu.kernels.chain import (
        chain_seeds, filter_chains, l_rep_device, resolve_seeds)
    from bioseqdb_tpu.kernels.extend import extend_all
    from bioseqdb_tpu.kernels.seed import collect_seeds_device

    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    max_occ = opt.resolve_max_occ(n_refs)

    def inner(fms_l, codes, lens, mat):
        fm = _local_fm(fms_l)
        codes = codes.astype(jnp.int32)  # uint8 on the wire
        # match pipeline.full_align_step (max_cand scales ~log4(genome))
        if codes.shape[1] <= 200:
            caps = dict(max_cand=max_cand or 16, max_mem=16)
        else:
            caps = dict(max_cand=max_cand) if max_cand else {}
        mems = collect_seeds_device(
            fm, codes, lens, min_seed_len=opt.min_seed_len,
            split_len=split_len, split_width=opt.split_width,
            max_mem_intv=opt.max_mem_intv, shard_axis=axis, **caps,
        )
        seeds = resolve_seeds(fm, mems["mems"], mems["n_mem"],
                              max_occ=max_occ, max_seeds=max_seeds,
                              shard_axis=axis, sa_interval=sa_interval)
        chains = chain_seeds(fm, seeds, max_chains=max_chains,
                             bandwidth=opt.bandwidth,
                             max_chain_gap=opt.max_chain_gap)
        flt = filter_chains(chains, seeds, mask_level=opt.mask_level,
                            chain_drop_ratio=opt.chain_drop_ratio,
                            min_chain_weight=opt.min_chain_weight,
                            min_seed_len=opt.min_seed_len,
                            max_chain_gap=opt.max_chain_gap)
        ext = extend_all(
            fm, fms_l.pac[0], codes, lens, seeds, chains, flt, mat,
            match_score=opt.match_score,
            mismatch_penalty=opt.mismatch_penalty,
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, bandwidth=opt.bandwidth, zdrop=opt.zdrop,
            pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
            shard_axis=axis, sw_kernel=sw_kernel,
        )
        overflow = (mems["overflow"] | seeds["overflow"]
                    | chains["overflow"] | ext["overflow"])
        regs = dict(ext["regs"])
        regs.pop("cchain", None)  # extend-internal; the host never reads it
        out = dict(regs=regs, n_regs=ext["n_regs"],
                   overflow=overflow,
                   l_rep=l_rep_device(mems["mems"], mems["n_mem"],
                                      max_occ=max_occ))
        if keep_mems:
            out["mems"] = mems["mems"]
            out["n_mem"] = mems["n_mem"]
        return out

    batch_spec = P(data_axis) if data_axis else P()
    out_skel = dict(regs=dict(rb=0, re=0, qb=0, qe=0, score=0, truesc=0, w=0,
                              seedlen0=0, rid=0, seedcov=0),
                    n_regs=0, overflow=0, l_rep=0)
    if keep_mems:
        out_skel["mems"] = 0
        out_skel["n_mem"] = 0
    out_spec = jax.tree.map(lambda _: batch_spec, out_skel)
    # check_vma=False: the state-machine loop carries mix replicated
    # constants with data-sharded values, which the varying-axis type
    # checker rejects even though the computation is well-defined
    return jax.shard_map(
        inner, mesh=mesh,
        in_specs=_in_specs(mesh, axis, data_axis, 2) + (P(),),
        out_specs=out_spec,
        check_vma=False,
    )(fms, codes, lens, mat)
