"""chr20-scale PE finalize cost breakdown.

Runs the fused pair dispatch once on the available backend to get real
region tables, then profiles finalize_pairs_columns: slow-pair count
and composition, wall time of the prelude / fast block / slow loop,
and a cProfile of the slow loop.

    python tools/profile_pe_slow.py [pairs] [genome_mb]
"""
import sys; sys.path.insert(0, __file__.rsplit("/", 2)[0])  # noqa: E702
import cProfile
import pstats
import time

import numpy as np


def log(*a):
    print("[pe]", *a, flush=True)


def main():
    import jax

    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bioseqdb_tpu.align import paired
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_pairs

    PB = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    mb = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    t0 = time.time()
    g = simulate_genome(mb * 1_000_000, seed=20)
    idx = build_index([("chr20", g)])
    log(f"index built {time.time()-t0:.0f}s")
    al = Aligner.build(idx, AlignOptions(), mode="full")
    log(f"seeder: {'kmer' if al.kmer_meta is not None else 'fm'}")
    sr1, sr2, _ = simulate_pairs(g, PB, read_len=150, sub_rate=0.01,
                                 insert_mean=400, insert_std=40, seed=900)
    b1 = pack_reads(sr1.reads, sr1.names)
    b2 = pack_reads(sr2.reads, sr2.names)
    t0 = time.time()
    o1, o2 = al.device_regions_pair(b1, b2)
    out1, out2 = jax.device_get(o1), jax.device_get(o2)
    log(f"device pair dispatch: {time.time()-t0:.1f}s (incl. compile)")
    t0 = time.time()
    out1, out2 = al.absorb_overflow_pair(b1, out1, b2, out2)
    log(f"absorb_overflow_pair: {time.time()-t0:.2f}s")

    opt = al.options
    # prelude alone
    t0 = time.time()
    n, mat, f1, f2, pes, fast_pair, all_regs = paired._pairs_prelude(
        idx, opt, b1, out1, b2, out2)
    t_prelude = time.time() - t0
    slow = np.flatnonzero(~fast_pair[:n])
    log(f"prelude {t_prelude*1e3:.0f} ms; fast {int(fast_pair.sum())}/{n}, "
        f"slow {slow.size}")
    nregs1 = np.asarray(out1["n_regs"])[:n]
    nregs2 = np.asarray(out2["n_regs"])[:n]
    multi = ((nregs1 > 1) | (nregs2 > 1))[slow]
    log(f"slow composition: multi-region {int(multi.sum())}, "
        f"rescue-candidate(single-region) {int((~multi).sum())}")

    # slow loop alone
    t0 = time.time()
    res = []
    for i in slow.tolist():
        (q1, regs1), (q2, regs2) = all_regs[i]
        res.append(paired._pair_slow_one(
            idx, opt, mat, pes, b1.names[i], q1, regs1, q2, regs2,
            rid1=i, rid2=(1 << 20) + i))
    t_slow = time.time() - t0
    log(f"slow loop: {t_slow*1e3:.0f} ms total, "
        f"{t_slow/max(slow.size,1)*1e3:.2f} ms/pair")

    # full finalize wall
    t0 = time.time()
    paired.finalize_pairs_columns(idx, opt, b1, out1, b2, out2)
    log(f"finalize_pairs_columns total: {(time.time()-t0)*1e3:.0f} ms")

    pr = cProfile.Profile()
    pr.enable()
    for i in slow.tolist():
        (q1, regs1), (q2, regs2) = all_regs[i]
        paired._pair_slow_one(idx, opt, mat, pes, b1.names[i],
                              q1, regs1, q2, regs2, rid1=i,
                              rid2=(1 << 20) + i)
    pr.disable()
    stats = pstats.Stats(pr)
    stats.sort_stats("cumulative")
    stats.print_stats(22)


if __name__ == "__main__":
    main()
