"""GRCh38-scale ON-CHIP check (ROADMAP #1, BASELINE config 4 scope).

Loads the 3.1 Gbase index saved by tools/grch38_scale_check.py (6.2 G
doubled bases -> int64 rank arithmetic under jax x64), puts the tables
(~6.5 GB) in one GPU's memory, runs the FULL device pipeline on simulated
reads, validates against truth positions, and reports reads/s.

    PYTHONPATH=. python tools/grch38_chip_check.py [.bigindex] [batch]
"""
import sys; sys.path.insert(0, __file__.rsplit("/", 2)[0])  # noqa: E702
import os
import time

import numpy as np

os.environ.setdefault("JAX_ENABLE_X64", "1")


def log(*a):
    print("[chip]", *a, file=sys.stderr, flush=True)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bioseqdb_tpu.align.finalize import finalize_batch
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.index.fmindex import FMIndex
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

    out_dir = sys.argv[1] if len(sys.argv) > 1 else ".bigindex"
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    reads_npz = sys.argv[3] if len(sys.argv) > 3 else None
    t0 = time.time()
    sub = os.path.join(out_dir, "grch38_scale.idx")
    idx = FMIndex.load(sub if os.path.isdir(sub) else out_dir)
    log(f"index loaded in {time.time()-t0:.0f}s: doubled "
        f"{idx.seq_len/1e9:.2f}G, sa_interval {idx.sa_interval}, "
        f"blocks {idx.blocks.nbytes/2**30:.2f} GiB")
    assert idx.seq_len + 1 >= 2**31, "expected an int64-rank index"

    t0 = time.time()
    if reads_npz:  # pre-simulated truth reads saved next to the build
        data = np.load(reads_npz, allow_pickle=True)
        reads = [str(r) for r in data["reads"]][:B]
        B = len(reads)
        positions, strands = data["positions"][:B], data["strands"][:B]
        log(f"{B} saved reads loaded")
    else:
        # reads must come from the same generator stream as the build
        # tool's genome (simulate_genome(n, seed=5))
        g = simulate_genome(idx.l_pac, seed=5)
        sim = simulate_reads(g, B, read_len=150, sub_rate=0.01, seed=11)
        del g
        positions, strands = sim.positions, sim.strands
        reads = sim.reads
        log(f"genome re-simulated + {B} reads in {time.time()-t0:.0f}s")
    batch = pack_reads(reads, [f"r{i}" for i in range(B)])

    t0 = time.time()
    al = Aligner.build(idx, AlignOptions(), mode="full")
    log(f"device tables resident in {time.time()-t0:.0f}s "
        f"(device={jax.devices()[0]}, table {al.table})")

    t0 = time.time()
    out = jax.device_get(al.device_regions(batch))
    log(f"full pipeline compile+first batch: {time.time()-t0:.0f}s")
    t0 = time.time()
    res = finalize_batch(idx, al.options, batch, out)
    log(f"host finalize: {time.time()-t0:.1f}s")

    ok = sum(
        1 for r, p, s in zip(res, positions, strands)
        if r.mapped and r.primary.ref_begin == p
        and r.primary.is_reverse == bool(s)
    )
    novf = int(np.asarray(out["overflow"]).sum())
    log(f"truth: {ok}/{B} (overflow {novf})")
    assert ok >= 0.95 * B, "GRCh38-scale on-chip truth check failed"

    # steady-state throughput (batch already compiled)
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        o = jax.device_get(al.device_regions(batch))
    dt = (time.time() - t0) / reps
    log(f"device pipeline: {dt*1e3:.0f} ms/batch = {B/dt:,.0f} reads/s")
    print("GRCH38-SCALE ON-CHIP: PASS", flush=True)


if __name__ == "__main__":
    main()
