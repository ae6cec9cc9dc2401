"""Histogram the kmer seeder's fallback causes ('why' bitmask) and the
needs_r2 rate on a bench-shaped batch.

    python tools/kmer_why_census.py [B] [genome_len]
"""
import sys; sys.path.insert(0, __file__.rsplit("/", 2)[0])  # noqa: E702
import collections
import time

import numpy as np

BITS = ["mz_overflow", "capped_bucket", "diag_overflow", "r1_multi",
        "mem_cap", "r3_multi", "r3_stuck"]


def main():
    import jax
    import jax.numpy as jnp

    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.kernels import kmer as kkm
    from bioseqdb_tpu.kernels.extend import pack_doubled_rows
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    glen = int(sys.argv[2]) if len(sys.argv) > 2 else 4_600_000
    g = simulate_genome(glen, seed=1)
    idx = build_index([("g", g)])
    opt = AlignOptions()
    host, meta = idx.kmer_table_arrays(kkm.build_kmer_table)
    kt = kkm.KmerTable(bmeta=jnp.asarray(host["bmeta"]),
                       entries=jnp.asarray(host["entries"]))
    pac_dev = jnp.asarray(idx.packed_doubled_rows(pack_doubled_rows))
    sim = simulate_reads(g, B, read_len=150, sub_rate=0.01, seed=100)
    rb = pack_reads(sim.reads, sim.names)
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    nmz = kkm.nmz_for(rb.codes.shape[1])
    out = jax.device_get(kkm.collect_seeds_kmer(
        kt, pac_dev, idx.seq_len, jnp.asarray(rb.codes, jnp.int32),
        jnp.asarray(rb.lens, jnp.int32), bb=meta.bb,
        min_seed_len=opt.min_seed_len, split_len=split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        smax=kkm.smax_for(opt.max_mem_intv),
        dmax=kkm.dmax_for(meta, nmz), nmz=nmz, max_mem=16))
    why = np.asarray(out["why"])
    ovf = int(np.count_nonzero(why))
    print(f"B={B} glen={glen}: overflow {ovf} ({100*ovf/B:.3f}%), "
          f"needs_r2 {int(out['needs_r2'].sum())} "
          f"({100*out['needs_r2'].sum()/B:.3f}%)")
    per_bit = {name: int(((why >> b) & 1).sum())
               for b, name in enumerate(BITS)}
    print("per-cause:", per_bit)
    only = collections.Counter()
    for w in why[why > 0]:
        only["+".join(n for b, n in enumerate(BITS) if (w >> b) & 1)] += 1
    print("combos:", dict(only))


if __name__ == "__main__":
    main()
