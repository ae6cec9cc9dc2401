"""Per-stage overflow census at a given genome scale.

Reads that overflow a device cap fall back to the host oracle, whose
per-read cost makes a small overflow rate the whole batch cost at
chr20 scale. This splits the overflow by producing stage (seeding caps, seed
resolution, chaining, extension) and prints the tail distributions the
caps cut, so the fix is a measured cap choice instead of a guess.

Usage: python tools/overflow_census.py [genome_mb] [batch]
"""

import sys
import time

import numpy as np


def log(*a):
    print("[ovf]", *a, file=sys.stderr, flush=True)


def main():
    import jax

    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.kernels import fm as kfm
    from bioseqdb_tpu.kernels.chain import (chain_seeds, filter_chains,
                                            resolve_seeds)
    from bioseqdb_tpu.kernels.extend import extend_all, pack_doubled_rows
    from bioseqdb_tpu.kernels.seed import build_seed_table, \
        collect_seeds_device
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
    opt = AlignOptions()
    t0 = time.time()
    genome = simulate_genome(mb * 1_000_000, seed=20)
    idx = build_index([("chr", genome)])
    log(f"{mb} Mb index built in {time.time() - t0:.1f}s")
    fm, table = build_seed_table(kfm.FMDevice.from_host(idx), idx)
    pac_dev = jax.device_put(
        jnp.asarray(pack_doubled_rows(np.asarray(idx.pac))))
    sim = simulate_reads(genome, B, read_len=150, sub_rate=0.01, seed=900)
    rb = pack_reads(sim.reads, sim.names)
    codes = jnp.asarray(rb.codes, jnp.int32)
    lens = jnp.asarray(rb.lens, jnp.int32)
    mat = jnp.asarray(
        fill_scmat(opt.match_score, opt.mismatch_penalty).astype(np.int32))
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    max_occ = opt.resolve_max_occ(idx.n_refs)

    # mirror _full_align_step's short-read caps, but probe headroom too
    for max_cand, max_mem in ((16, 16), (24, 24), (32, 32)):
        mems = jax.device_get(collect_seeds_device(
            fm, codes, lens, min_seed_len=opt.min_seed_len,
            split_len=split_len, split_width=opt.split_width,
            max_mem_intv=opt.max_mem_intv,
            jump_base=table.jump_base, jump_depth=table.jump_depth,
            sa_interval=idx.sa_interval, max_cand=max_cand, max_mem=max_mem))
        n_mem = mems["n_mem"]
        ovf = mems["overflow"]
        log(f"seed caps cand/mem={max_cand}/{max_mem}: overflow "
            f"{int(ovf.sum())}/{B}  n_mem p50/p99/max "
            f"{np.percentile(n_mem, 50):.0f}/{np.percentile(n_mem, 99):.0f}"
            f"/{n_mem.max()}")
        if max_cand == 16:
            mems16 = mems

    mems = {k: jnp.asarray(v) for k, v in mems16.items()}
    seeds = jax.device_get(resolve_seeds(
        fm, mems["mems"], mems["n_mem"], max_occ=max_occ,
        max_seeds=64, sa_interval=idx.sa_interval))
    nsd = seeds["valid"].sum(axis=1)
    log(f"resolve max_seeds=64: overflow {int(seeds['overflow'].sum())}/{B}  "
        f"n_seeds p50/p99/max {np.percentile(nsd, 50):.0f}/"
        f"{np.percentile(nsd, 99):.0f}/{nsd.max()}")
    seeds_d = {k: jnp.asarray(v) for k, v in seeds.items()}
    chains = jax.device_get(chain_seeds(
        fm, seeds_d, max_chains=8, bandwidth=opt.bandwidth,
        max_chain_gap=opt.max_chain_gap))
    log(f"chain max_chains=8: overflow {int(chains['overflow'].sum())}/{B}  "
        f"n_chains p50/p99/max {np.percentile(chains['n'], 50):.0f}/"
        f"{np.percentile(chains['n'], 99):.0f}/{chains['n'].max()}")
    chains_d = {k: jnp.asarray(v) for k, v in chains.items()}
    flt = filter_chains(chains_d, seeds_d, mask_level=opt.mask_level,
                        chain_drop_ratio=opt.chain_drop_ratio,
                        min_chain_weight=opt.min_chain_weight,
                        min_seed_len=opt.min_seed_len,
                        max_chain_gap=opt.max_chain_gap)
    ext = jax.device_get(extend_all(
        fm, pac_dev, codes, lens, seeds_d, chains_d, flt, mat,
        match_score=opt.match_score, mismatch_penalty=opt.mismatch_penalty,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        bandwidth=opt.bandwidth, zdrop=opt.zdrop,
        pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3))
    log(f"extend: overflow {int(ext['overflow'].sum())}/{B}  "
        f"n_regs p50/p99/max {np.percentile(ext['n_regs'], 50):.0f}/"
        f"{np.percentile(ext['n_regs'], 99):.0f}/{ext['n_regs'].max()}")


if __name__ == "__main__":
    main()
