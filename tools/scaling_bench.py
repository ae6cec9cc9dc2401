"""Data-parallel scaling-efficiency benchmark (SURVEY.md §2b) — the
harness for the north star's ">= 85% efficiency 1 -> 2 hosts" gate
(BASELINE.md config 5).

Multi-host scale-out uses the ``data`` axis only — per-host read
shards, replicated index, no per-iteration cross-host collectives — so
the only cross-host costs are input distribution and the end-of-batch
result gather.

## One host (the GPUs of one machine, or a virtual CPU mesh)

    python tools/scaling_bench.py --devices 1 2 4
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py --devices 1 2 4 8

## 1 -> N hosts

1-host baseline (on ONE host, its local GPUs only):

    python tools/scaling_bench.py --devices 4 --passes 5 \
        --genome 4600000 --reads-per-device 2048

N-host run (one process per host, each given the coordinator's
``host:port``, the process count and its own index):

    python tools/scaling_bench.py --multihost HOST:PORT N I --passes 5 \
        --genome 4600000 --reads-per-device 2048 \
        --baseline-rps <reads_per_s from the 1-host run>

The JSON line then carries ``host_efficiency`` = reads/s divided by
(baseline * n_hosts) — the north-star metric. Timing reduces the
output to a replicated scalar inside jit (a device_get of sharded
tables would fail multi-process); each pass is scored whole,
median-of-passes reported.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--genome", type=int, default=1_000_000)
    p.add_argument("--reads-per-device", type=int, default=512)
    p.add_argument("--read-len", type=int, default=150)
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--multihost", nargs=3,
                   metavar=("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID"),
                   help="jax.distributed over all hosts; one global "
                        "data-axis mesh over every device")
    p.add_argument("--baseline-rps", type=float, default=0.0,
                   help="1-host reads/s for host_efficiency")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from bioseqdb_tpu.dist.mesh import init_distributed
    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.multihost:
        coord, n_proc, proc_id = args.multihost
        init_distributed(coord, int(n_proc), int(proc_id))

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.dist.mesh import make_mesh
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
    from bioseqdb_tpu.index.builder import build_index

    genome = simulate_genome(args.genome, seed=1)
    idx = build_index([("ref", genome)])
    avail = len(jax.devices())
    n_hosts = jax.process_count()
    counts = ([avail] if args.multihost
              else [d for d in args.devices if d <= avail])
    is_main = jax.process_index() == 0
    if is_main:
        print(f"[scaling] hosts {n_hosts}, devices {avail}; "
              f"measuring {counts}", file=sys.stderr)

    def run_counted(n_dev):
        mesh = make_mesh(n_dev)
        aligner = Aligner.build(idx, AlignOptions(), mode="full", mesh=mesh)
        n_reads = args.reads_per_device * n_dev
        sim = simulate_reads(genome, n_reads, read_len=args.read_len,
                             sub_rate=0.01, seed=2)
        batch = pack_reads(sim.reads, sim.names, pad_reads_to=n_dev)

        # reduce to a replicated scalar: timing stays on-device work,
        # and multi-process device_get of sharded tables is illegal
        @jax.jit
        def checksum(tree):
            return sum(jnp.sum(x.astype(jnp.int32)) for x in
                       jax.tree_util.tree_leaves(tree))

        jax.device_get(checksum(aligner.device_regions(batch)))  # warm
        ts = []
        for _ in range(max(args.passes, 1)):
            t0 = time.time()
            jax.device_get(checksum(aligner.device_regions(batch)))
            ts.append(time.time() - t0)
        return n_reads / statistics.median(ts)

    base_rps = None
    rows = []
    for n_dev in counts:
        rps = run_counted(n_dev)
        if base_rps is None:
            base_rps = rps
        eff = rps / (base_rps * n_dev / counts[0])
        row = {"devices": n_dev, "hosts": n_hosts,
               "reads_per_s": round(rps), "efficiency": round(eff, 3)}
        if args.baseline_rps > 0:
            row["host_efficiency"] = round(
                rps / (args.baseline_rps * n_hosts), 3)
        rows.append(row)
        if is_main:
            print(f"[scaling] {n_hosts} host(s) x {n_dev} device(s): "
                  f"{rps:,.0f} reads/s (efficiency {eff:.1%})",
                  file=sys.stderr)
    if is_main:
        print(json.dumps({"scaling": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
