"""Multi-process distributed execution check (SURVEY §4).

Spawns N real `jax.distributed` processes on the CPU backend (each
contributing its local virtual devices to one global mesh), runs the
BWT-interval-sharded full pipeline over a (data x index) mesh that spans
BOTH processes, and checks every process's addressable output shards
against a single-process reference computed on identical inputs.

This exercises exactly the multi-host layout of BASELINE configs 4-5
(dist/mesh.py init_distributed path): index shards placed across
processes, reads data-parallel across processes, rank-query psums riding
the cross-process collectives.

    python tools/multiproc_check.py            # parent: spawns 2 workers
    (workers re-exec this file with BST_MP_RANK set)
"""
import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
DEV_PER_PROC = 2  # virtual CPU devices per process
PORT = int(os.environ.get("BST_MP_PORT", "9781"))
REF_PKL = "/tmp/bst_mp_ref.pkl"


def build_inputs():
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

    genome = simulate_genome(30_000, seed=51)
    idx = build_index([("ref", genome)])
    sim = simulate_reads(genome, 32, read_len=100, sub_rate=0.02, seed=52)
    batch = pack_reads(sim.reads, sim.names, pad_reads_to=4)
    return idx, batch


def reference():
    """Single-process unsharded regions (the ground truth)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np

    from bioseqdb_tpu.align.finalize import maybe_unpack
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner

    idx, batch = build_inputs()
    al = Aligner.build(idx, AlignOptions(), mode="full")
    out = maybe_unpack(jax.device_get(al.device_regions(batch)))
    ref = {("regs", k): np.asarray(v) for k, v in out["regs"].items()}
    ref["n_regs"] = np.asarray(out["n_regs"])
    with open(REF_PKL, "wb") as fh:
        pickle.dump(ref, fh)
    print(f"[parent] reference written ({ref['n_regs'].shape[0]} rows)")


def worker(rank: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
    ).strip()
    import jax

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=N_PROC,
        process_id=rank,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.dist.shard_index import (full_align_step_sharded,
                                               shard_index)

    devs = jax.devices()
    assert len(devs) == N_PROC * DEV_PER_PROC, devs
    assert len(jax.local_devices()) == DEV_PER_PROC
    # data axis spans PROCESSES (one data row-block per process), index
    # axis spans the local devices — index shards live on different
    # processes' devices too (device order interleaves processes)
    mesh = Mesh(np.array(devs).reshape(2, 2), axis_names=("data", "index"))

    idx, batch = build_inputs()
    opt = AlignOptions()
    fms = shard_index(idx, mesh)
    sh = NamedSharding(mesh, P("data"))
    codes = jax.device_put(np.asarray(batch.codes, np.uint8), sh)
    lens = jax.device_put(np.asarray(batch.lens, np.int32), sh)
    mat = jax.device_put(
        jnp.asarray(fill_scmat(1, 4).astype(np.int32)),
        NamedSharding(mesh, P()))
    out = full_align_step_sharded(
        fms, codes, lens, mat, mesh, opt, idx.n_refs, data_axis="data",
        sa_interval=idx.sa_interval,
    )
    with open(REF_PKL, "rb") as fh:
        ref = pickle.load(fh)

    def check(name, garr):
        want = ref[name]
        for s in garr.addressable_shards:
            rows = s.index[0] if s.index else slice(None)
            got = np.asarray(s.data)
            np.testing.assert_array_equal(
                got, want[s.index], err_msg=f"{name} shard {s.index}")

    for k in ("rb", "re", "qb", "qe", "score", "truesc", "seedcov"):
        check(("regs", k), out["regs"][k])
    check("n_regs", out["n_regs"])
    print(f"[worker {rank}] sharded output matches reference "
          f"({len(jax.local_devices())} local / {len(devs)} global devices)",
          flush=True)
    jax.distributed.shutdown()


def main():
    rank = os.environ.get("BST_MP_RANK")
    if rank is not None:
        worker(int(rank))
        return
    reference()
    procs = []
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    for r in range(N_PROC):
        e = dict(env, BST_MP_RANK=str(r), JAX_PLATFORMS="cpu",
                 PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ok = True
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=1800)  # contended 2-core hosts: the check itself takes ~6 min
        sys.stdout.write(out)
        if p.returncode != 0 or "matches reference" not in out:
            ok = False
            print(f"[parent] worker {r} FAILED (rc={p.returncode})")
    if not ok:
        sys.exit(1)
    print("MULTIPROC CHECK: PASS")


if __name__ == "__main__":
    main()
