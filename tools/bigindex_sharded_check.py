"""Sharded-vs-replicated equality at REAL human scale: load a >2^31-doubled-base saved index (int64 ranks over int32
tables — the configuration where BWT-interval sharding is load-bearing,
BASELINE config 4 scope), run the FULL sharded pipeline over a virtual
(data x index) CPU mesh, and match the replicated pipeline's output on
the same reads, plus ground truth.

Build the index first (a 1.55 Gbase synthetic, ~55 min host):
    python /tmp/build_bigidx.py         # or any FMIndex.save dir
Run:
    PYTHONPATH=. python tools/bigindex_sharded_check.py \
        [index_dir=/root/bigidx155] [reads_npz] [B=64]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def log(*a):
    print("[bigshard]", *a, file=sys.stderr, flush=True)


def main():
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import full_align_step
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.dist.shard_index import (full_align_step_sharded,
                                               shard_index)
    from bioseqdb_tpu.index.fmindex import FMIndex
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.kernels import fm as kfm

    idx_dir = sys.argv[1] if len(sys.argv) > 1 else "/root/bigidx155"
    npz = sys.argv[2] if len(sys.argv) > 2 else "/root/bigidx155_reads.npz"
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 64

    t0 = time.time()
    idx = FMIndex.load(idx_dir)
    log(f"index loaded in {time.time() - t0:.1f}s: doubled "
        f"{idx.seq_len / 1e9:.2f}G (int64 ranks: {idx.seq_len >= 2**31}), "
        f"sa_interval {idx.sa_interval}")
    assert idx.seq_len >= 2**31, "index not at sharding-load-bearing scale"
    data = np.load(npz, allow_pickle=True)
    reads = [str(r) for r in data["reads"][:B]]
    positions = data["positions"][:B]
    strands = data["strands"][:B]
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    codes = jnp.asarray(batch.codes, jnp.int32)
    lens = jnp.asarray(batch.lens, jnp.int32)
    mat = jnp.asarray(fill_scmat(1, 4).astype(np.int32))
    opt = AlignOptions()

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("data", "index"))
    t0 = time.time()
    fms = shard_index(idx, mesh)
    log(f"sharded tables placed over {mesh} in {time.time() - t0:.1f}s")
    t0 = time.time()
    out_sh = jax.device_get(full_align_step_sharded(
        fms, codes, lens, mat, mesh, opt, idx.n_refs, data_axis="data",
        sa_interval=idx.sa_interval, max_cand=24, keep_mems=True))
    log(f"sharded pipeline: {len(reads)} reads in {time.time() - t0:.1f}s")

    t0 = time.time()
    fm = kfm.FMDevice.from_host(idx, rank_dtype=jnp.int64)
    pac_dev = jnp.asarray(np.asarray(idx.pac), jnp.int8)
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    out_rep = jax.device_get(full_align_step(
        fm, pac_dev, codes, lens, mat,
        min_seed_len=opt.min_seed_len, split_len=split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        max_occ=opt.resolve_max_occ(idx.n_refs), max_seeds=64,
        max_chains=16, match_score=opt.match_score,
        mismatch_penalty=opt.mismatch_penalty,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        bandwidth=opt.bandwidth, zdrop=opt.zdrop,
        pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
        min_chain_weight=opt.min_chain_weight,
        max_chain_gap=opt.max_chain_gap, mask_level=opt.mask_level,
        chain_drop_ratio=opt.chain_drop_ratio,
        sa_interval=idx.sa_interval, max_cand=24, keep_mems=True))
    log(f"replicated pipeline: {time.time() - t0:.1f}s")

    n = batch.n
    bad_rows = set()
    for f in ("rb", "re", "qb", "qe", "score", "truesc", "seedcov", "rid"):
        a = np.asarray(out_sh["regs"][f])[:n]
        b = np.asarray(out_rep["regs"][f])[:n]
        if not np.array_equal(a, b):
            rows = np.unique(np.argwhere(a != b)[:, 0])
            bad_rows.update(rows.tolist())
            log(f"regs.{f} differs on reads {rows[:8].tolist()}"
                f" ({len(rows)} reads)")
    nr_a = np.asarray(out_sh["n_regs"])[:n]
    nr_b = np.asarray(out_rep["n_regs"])[:n]
    if not np.array_equal(nr_a, nr_b):
        rows = np.flatnonzero(nr_a != nr_b)
        log(f"n_regs differs on reads {rows[:8].tolist()}: "
            f"sh={nr_a[rows[:8]].tolist()} rep={nr_b[rows[:8]].tolist()}")
        bad_rows.update(rows.tolist())
    ov_a = np.asarray(out_sh["overflow"])[:n]
    ov_b = np.asarray(out_rep["overflow"])[:n]
    if not np.array_equal(ov_a, ov_b):
        rows = np.flatnonzero(ov_a != ov_b)
        log(f"overflow differs on reads {rows[:8].tolist()} "
            f"(sh={ov_a[rows[:8]].tolist()})")
        bad_rows.update(rows.tolist())
    if "mems" in out_sh and "mems" in out_rep:
        ma = np.asarray(out_sh["mems"])[:n]
        mb = np.asarray(out_rep["mems"])[:n]
        if not np.array_equal(ma, mb):
            rows = np.unique(np.argwhere((ma != mb).any(axis=2))[:, 0])
            log(f"seed mems differ on reads {rows[:8].tolist()} "
                f"({len(rows)} reads) — divergence starts at SEEDING")
            i0 = int(rows[0])
            log(f"read {i0}: sh mems {ma[i0][:6].tolist()}")
            log(f"read {i0}: rep mems {mb[i0][:6].tolist()}")
    assert not bad_rows, f"{len(bad_rows)} reads differ"
    log("sharded == replicated on every region field")

    # ground truth on the primary-candidate coordinate
    nr = np.asarray(out_sh["n_regs"])[:n]
    rb = np.asarray(out_sh["regs"]["rb"])[:n]
    qb = np.asarray(out_sh["regs"]["qb"])[:n]
    ok = 0
    for i in range(n):
        if nr[i] < 1:
            continue
        best = int(np.argmax(np.asarray(out_sh["regs"]["score"])[i, :nr[i]]))
        pos, rev = idx.depos(int(rb[i, best]), int(lens[i]) - int(qb[i, best]))
        if abs(pos - int(positions[i])) <= 5 and rev == bool(strands[i]):
            ok += 1
    log(f"truth: {ok}/{n} primary candidates at the simulated origin")
    print(f"BIGINDEX SHARDED CHECK: {'PASS' if ok >= 0.95 * n else 'DEGRADED'}"
          f" ({ok}/{n} truth, fields equal)")


if __name__ == "__main__":
    main()
