"""Smoke test of the aligner's main path on NVIDIA GPUs, at real size.

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --four    # four GPUs: the multi-card meshes only

One GPU, in one process, through the entry points a user calls
(``Aligner.build`` -> ``device_regions``/``device_regions_pair`` ->
``absorb_overflow(_pair)`` -> ``finalize_columns``/
``finalize_pairs_columns``, and ``python -m bioseqdb_tpu align``):

1. sw_kernel: the CUDA banded-SW kernel against the XLA kernel
   (kernels/sw.py) on the DP sweeps of tests/test_sw_cuda.py and on
   16,384 lanes at the pipeline's shapes, then both timed in turns.
2. ecoli_se: a 4.6 Mb synthetic genome, one batch of 16,384 150 bp reads
   at 1% substitutions; the SE step's compile time and memory analysis;
   the batch timed with each SW kernel, whose records must be equal; a
   1,024-read subset run on JAX's CPU backend in this process, whose
   records must equal the GPU's.
3. ecoli_pe: 8,192 pairs, insert 400 +- 40, through the fused pair step.
4. long_reads: 288 reads of 1, 2 and 3 kb through the device path
   (kernels/seedsw.py), with the GPU's float32 log checked against the
   CPU's and a subset's records checked against the CPU backend's.
5. cli: ``align`` over a FASTQ of 16,384 reads, writing SAM.
6. chr20_pe: a 64 Mb synthetic genome (its kmer tables live on the
   device), 8,192 pairs.

Every phase checks reads at simulated truth (>= 98% SE, >= 95% PE read
1 and long reads) and classifies each read off truth against the host
oracle (cpu/oracle.py): device_ne_oracle must be 0. The pipeline is
integer DP; its only floats are float32 divides and one log, and it has
no matrix products, so TF32 never arises. Every comparison here is
exact: the tolerance is zero.

``--four`` runs only the multi-card path: one SE batch on a 1-D
``data`` mesh over four GPUs and on a 2x2 ``(data, index)`` mesh, each
compared record for record with the single-GPU run of the batch.

Any failure raises. The last line of stdout, printed only when every
phase passed, is ``{"ok": true, "device": {...}}``. Without a GPU the
script exits non-zero before any phase.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

import bench

GENOME_ECOLI = 4_600_000
GENOME_CHR20 = 64_000_000
SE_BATCH = 16_384
PAIRS = 8_192
CPU_SUBSET = 1_024
LONG_PER_LEN = 96  # long reads of each of 1, 2 and 3 kb


def log(*a):
    print("[smoke]", *a, flush=True)


def peak_bytes(jax) -> list[int]:
    return [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def sam_records(cols, idx, batch) -> dict:
    """Each read's SAM records (every line, every field and tag), by
    read name: what a user of the aligner receives."""
    from bioseqdb_tpu.sam.emit import emit_sam_columns

    text = emit_sam_columns(cols, idx, batch, header=False,
                            seqs=[batch.read_text(i) for i in range(batch.n)])
    out = {}
    for line in text.splitlines():
        out.setdefault(line.split("\t", 1)[0], []).append(line)
    return out


def assert_same_records(name, a: dict, b: dict, names):
    bad = [n for n in names if a.get(n) != b.get(n)]
    log(f"{name}: {len(names) - len(bad)}/{len(names)} reads' SAM records "
        f"equal")
    if bad:
        raise AssertionError(f"{name}: {len(bad)} reads differ; first "
                             f"{bad[0]}: {a.get(bad[0])} vs {b.get(bad[0])}")


def se_check(name, idx, al, batch, sim, cols, min_truth):
    at = bench.truth_mask(cols, sim.positions, sim.strands)
    classes = bench.classify_se(idx, al.options, batch, cols,
                                np.flatnonzero(~at))
    n = len(at)
    log(f"{name}: truth {int(at.sum())}/{n}; slow-path reads "
        f"{len(cols.extra)}; off-truth {classes}")
    if at.sum() < min_truth * n or classes["device_ne_oracle"]:
        raise AssertionError(f"{name} failed its correctness check")


def se_run(jax, al, idx, batch):
    """One SE batch through the served path; returns the columns."""
    from bioseqdb_tpu.align.columns import finalize_columns

    out = jax.device_get(jax.block_until_ready(al.device_regions(batch)))
    out = al.absorb_overflow(batch, out)
    return finalize_columns(idx, al.options, batch, out)


def pe_run(jax, al, idx, b1, b2):
    from bioseqdb_tpu.align.paired import finalize_pairs_columns

    o = jax.device_get(jax.block_until_ready(al.device_regions_pair(b1, b2)))
    o1, o2 = al.absorb_overflow_pair(b1, o[0], b2, o[1])
    c1, c2 = finalize_pairs_columns(idx, al.options, b1, o1, b2, o2)
    return o1, o2, c1, c2


def ab_turns(runs: dict, reps: int) -> dict:
    """Time each named callable in turns (a, b, b, a), ``reps`` calls per
    turn; returns the median seconds per call of each."""
    (na, fa), (nb, fb) = runs.items()
    times = {na: [], nb: []}
    for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
        for _ in range(reps):
            times[name].append(timed(fn)[1])
    return {k: statistics.median(v) for k, v in times.items()}


# ---- phases ---------------------------------------------------------------


def phase_sw_kernel(jax):
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_sw_cuda as T
    from bioseqdb_tpu.kernels.sw_cuda import sw_extend_batch_cuda, library_path

    _, build_s = timed(library_path)
    log(f"sw_kernel: nvcc build (or cached library) {build_s:.1f} s")
    for sweep in T.SWEEPS:
        args, kw = T.sweep_inputs(sweep)
        bad = T.compare_cuda_to_xla(args, **kw)
        log(f"sw_kernel: sweep {sweep[0]}: {len(args[1]) - bad}/"
            f"{len(args[1])} lanes equal")
        assert bad == 0, sweep[0]

    # the pipeline's extension shape: 150 bp query windows, targets of
    # query + up to 4 bandwidths, a mutated copy of the query planted
    B, WQ, WT = SE_BATCH, 152, 614
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, WQ)).astype(np.int32)
    qlen = rng.integers(20, WQ, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 120, B), WT).astype(np.int32)
    t = np.full((B, WT), 4, np.int32)
    t[:, :WQ] = np.where(rng.random((B, WQ)) < 0.04,
                         rng.integers(0, 4, (B, WQ)), q)
    t[np.arange(WT)[None, :] >= tlen[:, None]] = 4
    q[np.arange(WQ)[None, :] >= qlen[:, None]] = 4
    h0 = rng.integers(1, 100, B).astype(np.int32)
    w0 = np.full(B, 100, np.int32)
    dev = [jnp.asarray(a) for a in (q, qlen, t, tlen, w0, h0)]
    mat = jnp.asarray(T.fill_scmat(1, 4))
    from bioseqdb_tpu.kernels.sw import sw_extend_batch

    runs = {
        "cuda": lambda: jax.block_until_ready(sw_extend_batch_cuda(
            *dev, match_score=1, mismatch_penalty=4, end_bonus=5, zdrop=100,
            **T.GAPS)),
        "xla": lambda: jax.block_until_ready(sw_extend_batch(
            dev[0], dev[1], dev[2], dev[3], mat, 6, 1, 6, 1, dev[4], 5, 100,
            dev[5], WQ)),
    }
    got, c_s = timed(runs["cuda"])
    want, x_s = timed(runs["xla"])
    log(f"sw_kernel: first call (compile + run) cuda {c_s:.2f} s, "
        f"xla {x_s:.2f} s")
    bad = np.zeros(B, bool)
    for k in want:
        bad |= np.asarray(got[k]) != np.asarray(want[k])
    log(f"sw_kernel: {B - int(bad.sum())}/{B} lanes equal at B={B}, "
        f"max_qlen={WQ}, max_tlen={WT}")
    assert not bad.any()
    med = ab_turns(runs, reps=5)
    log(f"sw_kernel: A/B in turns, median per call: cuda "
        f"{med['cuda'] * 1e3:.3f} ms, xla {med['xla'] * 1e3:.3f} ms")
    return {f"sw_{k}_ms": round(v * 1e3, 3) for k, v in med.items()}


def se_step_aot(jax, al, batch):
    """Compile the SE device step ahead of time, as device_regions calls
    it; returns (compiled, seconds)."""
    import jax.numpy as jnp

    from bioseqdb_tpu.align import pipeline as P
    from bioseqdb_tpu.cpu.ksw import fill_scmat

    u2, nmb = P.pack_codes_2bit(np.asarray(batch.codes, np.uint8))
    B, W = u2.shape[0], u2.shape[1] * 4
    common, narrow = al._step_kwargs(W)
    opt = al.options
    mat = jnp.asarray(fill_scmat(opt.match_score,
                                 opt.mismatch_penalty).astype(np.int32))
    lowered = P._full_align_step_jit.lower(
        al.fm, al.pac_dev, (jnp.asarray(u2), jnp.asarray(nmb)),
        jnp.asarray(np.asarray(batch.lens, np.int32)), mat,
        pack_cap=(5 * B) // 4, pack_narrow=narrow, **common)
    return timed(lowered.compile)


def phase_ecoli_se(jax, idx, genome):
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_reads

    al = Aligner.build(idx, AlignOptions(), mode="full")
    assert al.platform() == "gpu" and al._sw_kwargs()["sw_kernel"] == "cuda"
    sim = simulate_reads(genome, SE_BATCH, read_len=150, sub_rate=0.01,
                         seed=100)
    batch = pack_reads(sim.reads, sim.names)
    compiled, comp_s = se_step_aot(jax, al, batch)
    m = compiled.memory_analysis()
    log(f"ecoli_se: SE step compile {comp_s:.1f} s; memory_analysis: "
        f"arguments {m.argument_size_in_bytes}, outputs "
        f"{m.output_size_in_bytes}, temps {m.temp_size_in_bytes}, code "
        f"{m.generated_code_size_in_bytes} bytes")
    cols, first_s = timed(se_run, jax, al, idx, batch)
    log(f"ecoli_se: first batch (cached step + fat-retry compile + "
        f"finalize) {first_s:.1f} s")
    se_check("ecoli_se", idx, al, batch, sim, cols, 0.98)

    # the same batch with the XLA SW kernel on the GPU
    al_xla = Aligner.build(idx, AlignOptions(), mode="full")
    al_xla._sw_kwargs = lambda: dict(sw_kernel="xla", sw_mesh=None)
    cols_x, first_x = timed(se_run, jax, al_xla, idx, batch)
    log(f"ecoli_se: XLA-SW variant first batch (compile + run) "
        f"{first_x:.1f} s")
    recs = sam_records(cols, idx, batch)
    assert_same_records("ecoli_se cuda vs xla SW kernel", recs,
                        sam_records(cols_x, idx, batch), batch.names)
    dev_ms = ab_turns({
        "cuda": lambda: jax.block_until_ready(al.device_regions(batch)),
        "xla": lambda: jax.block_until_ready(al_xla.device_regions(batch)),
    }, reps=3)
    e2e = ab_turns({"cuda": lambda: se_run(jax, al, idx, batch),
                    "xla": lambda: se_run(jax, al_xla, idx, batch)}, reps=2)
    log(f"ecoli_se: device step median: cuda {dev_ms['cuda'] * 1e3:.1f} ms, "
        f"xla {dev_ms['xla'] * 1e3:.1f} ms; end to end (device + overflow "
        f"retry + finalize): cuda {e2e['cuda'] * 1e3:.1f} ms, xla "
        f"{e2e['xla'] * 1e3:.1f} ms per {SE_BATCH} reads")
    del al_xla

    # a subset on JAX's CPU backend, in this process
    sub = pack_reads(sim.reads[:CPU_SUBSET], sim.names[:CPU_SUBSET])
    with jax.default_device(jax.devices("cpu")[0]):
        al_cpu = Aligner.build(idx, AlignOptions(), mode="full")
        assert al_cpu.platform() == "cpu"
        cols_c, cpu_s = timed(se_run, jax, al_cpu, idx, sub)
    log(f"ecoli_se: CPU-backend subset (compile + run) {cpu_s:.1f} s")
    assert_same_records("ecoli_se GPU vs CPU backend", recs,
                        sam_records(cols_c, idx, sub), sub.names)
    return al, dict(se_compile_s=round(comp_s, 1),
                    se_device_ms_cuda=round(dev_ms["cuda"] * 1e3, 1),
                    se_device_ms_xla=round(dev_ms["xla"] * 1e3, 1),
                    se_e2e_ms_cuda=round(e2e["cuda"] * 1e3, 1),
                    se_e2e_ms_xla=round(e2e["xla"] * 1e3, 1))


def pe_phase(jax, name, idx, genome, al, seed):
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_pairs

    s1, s2, _ = simulate_pairs(genome, PAIRS, read_len=150, sub_rate=0.01,
                               insert_mean=400, insert_std=40, seed=seed)
    b1, b2 = pack_reads(s1.reads, s1.names), pack_reads(s2.reads, s2.names)
    (o1, o2, c1, _), first_s = timed(pe_run, jax, al, idx, b1, b2)
    at = bench.truth_mask(c1, s1.positions)
    classes = bench.classify_pe(idx, al.options, b1, o1, b2, o2, c1,
                                np.flatnonzero(~at))
    proper = int((c1.pe_flag[:PAIRS] & 0x2 > 0).sum())
    log(f"{name}: first pair batch (compile + run) {first_s:.1f} s; truth "
        f"(read 1) {int(at.sum())}/{PAIRS}; proper {proper}/{PAIRS}; "
        f"slow-path reads {len(c1.extra)}; off-truth {classes}")
    if at.sum() < 0.95 * PAIRS or classes["device_ne_oracle"]:
        raise AssertionError(f"{name} failed its correctness check")
    e2e = [timed(pe_run, jax, al, idx, b1, b2)[1] for _ in range(3)]
    log(f"{name}: end to end median {statistics.median(e2e) * 1e3:.1f} ms "
        f"per {2 * PAIRS} reads")
    return {f"{name}_e2e_ms": round(statistics.median(e2e) * 1e3, 1)}


def phase_long_reads(jax, idx, genome, al):
    import jax.numpy as jnp

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import SimulatedReads, simulate_reads

    n = LONG_PER_LEN
    parts = [simulate_reads(genome, n, read_len=L, sub_rate=0.01,
                            seed=400 + L) for L in (1000, 2000, 3000)]
    sim = SimulatedReads(
        reads=sum((p.reads for p in parts), []),
        names=[f"long{i}" for i in range(3 * n)],
        positions=np.concatenate([p.positions for p in parts]),
        strands=np.concatenate([p.strands for p in parts]),
        n_subs=np.concatenate([p.n_subs for p in parts]))
    batch = pack_reads(sim.reads, sim.names)
    cols, first_s = timed(se_run, jax, al, idx, batch)
    log(f"long_reads: {batch.n} reads, width {batch.width}: first batch "
        f"(compile + run) {first_s:.1f} s")
    se_check("long_reads", idx, al, batch, sim, cols, 0.95)

    # seedsw.py's per-read gate takes a float32 log of the read length
    lens = np.asarray(batch.lens[: batch.n])
    flog = jax.jit(lambda x: jnp.log(jnp.maximum(x, 1).astype(jnp.float32)))
    log_of = lambda dev: np.asarray(flog(jax.device_put(lens, dev)))
    lg, lc = log_of(jax.devices()[0]), log_of(jax.devices("cpu")[0])
    log(f"long_reads: float32 log(len) differs from the CPU's in "
        f"{int((lg.view(np.int32) != lc.view(np.int32)).sum())}/{batch.n} "
        f"reads")

    keep = [i for k in range(3) for i in range(n * k, n * k + min(n, 8))]
    sub = pack_reads([sim.reads[i] for i in keep],
                     [sim.names[i] for i in keep], width=batch.width)
    with jax.default_device(jax.devices("cpu")[0]):
        al_cpu = Aligner.build(idx, AlignOptions(), mode="full")
        cols_c, cpu_s = timed(se_run, jax, al_cpu, idx, sub)
    log(f"long_reads: CPU-backend subset (compile + run) {cpu_s:.1f} s")
    assert_same_records("long_reads GPU vs CPU backend",
                        sam_records(cols, idx, batch),
                        sam_records(cols_c, idx, sub), sub.names)
    return {"long_first_s": round(first_s, 1)}


def phase_cli(jax, idx, genome):
    from bioseqdb_tpu import cli
    from bioseqdb_tpu.io.fasta import FastaRecord, write_fastq
    from bioseqdb_tpu.utils.sim import simulate_reads

    sim = simulate_reads(genome, SE_BATCH, read_len=150, sub_rate=0.01,
                         seed=300)
    with tempfile.TemporaryDirectory() as tmp:
        ipath, fq, sam = (os.path.join(tmp, f) for f in
                          ("ecoli.idx", "reads.fq", "out.sam"))
        idx.save(ipath)
        write_fastq(fq, [FastaRecord(n, n, r) for n, r in
                         zip(sim.names, sim.reads)])
        rc, cli_s = timed(cli.main, ["align", ipath, fq, "-o", sam,
                                     "--batch-size", str(SE_BATCH)])
        assert rc == 0
        with open(sam) as fh:
            lines = [ln.split("\t") for ln in fh if not ln.startswith("@")]
    prim = {}
    for f in lines:
        flag = int(f[1])
        if flag & 0x900 == 0:
            score = next((int(t[5:]) for t in f[11:] if t.startswith("AS:i:")),
                         0)
            prim[f[0]] = (not flag & 0x4, int(f[3]) - 1, bool(flag & 0x10),
                          score)
    assert len(prim) == SE_BATCH, len(prim)
    n = SE_BATCH
    get = lambda k: np.array([prim[nm][k] for nm in sim.names])

    class Cols:  # the SAM records in bench.truth_mask's column form
        mapped, pos, is_rev, score = get(0), get(1), get(2), get(3)

    from bioseqdb_tpu.io.batch import pack_reads

    batch = pack_reads(sim.reads, sim.names)
    at = bench.truth_mask(Cols, sim.positions, sim.strands)
    classes = bench.classify_se(idx, _opts(), batch, Cols,
                                np.flatnonzero(~at))
    log(f"cli: align wrote {len(lines)} SAM records in {cli_s:.1f} s; truth "
        f"{int(at.sum())}/{n}; off-truth {classes}")
    if at.sum() < 0.98 * n or classes["device_ne_oracle"]:
        raise AssertionError("cli failed its correctness check")
    return {"cli_s": round(cli_s, 1)}


def _opts():
    from bioseqdb_tpu.align.options import AlignOptions

    return AlignOptions()


def one_card(jax, out):
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.utils.sim import simulate_genome

    def phase(name, fn, *a):
        t0 = time.time()
        res = fn(*a)
        out["phases"][name] = round(time.time() - t0, 1)
        log(f"{name}: done in {out['phases'][name]} s; peak_bytes_in_use "
            f"{peak_bytes(jax)[0]}")
        return res

    out["stats"].update(phase("sw_kernel", phase_sw_kernel, jax))
    genome = simulate_genome(GENOME_ECOLI, seed=1)
    (idx, build_s) = timed(build_index, [("ecoli", genome)])
    log(f"E. coli-scale index built in {build_s:.1f} s")
    al, st = phase("ecoli_se", phase_ecoli_se, jax, idx, genome)
    out["stats"].update(st)
    out["stats"].update(phase("ecoli_pe", pe_phase, jax, "ecoli_pe", idx,
                              genome, al, 700))
    out["stats"].update(phase("long_reads", phase_long_reads, jax, idx,
                              genome, al))
    out["stats"].update(phase("cli", phase_cli, jax, idx, genome))
    del al

    genome = simulate_genome(GENOME_CHR20, seed=20)
    (idx, build_s) = timed(build_index, [("chr20", genome)])
    al, set_s = timed(Aligner.build, idx, _opts(), mode="full")
    kt = al.kmer_table
    log(f"chr20-scale index built in {build_s:.1f} s, aligner bound in "
        f"{set_s:.1f} s; kmer tables on device: "
        f"{kt.bmeta.nbytes + kt.entries.nbytes} bytes")
    out["stats"].update(phase("chr20_pe", pe_phase, jax, "chr20_pe", idx,
                              genome, al, 900))


def four_cards(jax, out):
    from jax.sharding import Mesh

    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.dist.mesh import make_mesh
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    devs = jax.devices()[:4]
    genome = simulate_genome(GENOME_ECOLI, seed=1)
    idx = build_index([("ecoli", genome)])
    sim = simulate_reads(genome, SE_BATCH, read_len=150, sub_rate=0.01,
                         seed=100)
    batch = pack_reads(sim.reads, sim.names)
    single = Aligner.build(idx, _opts(), mode="full")
    ref, s = timed(se_run, jax, single, idx, batch)
    log(f"four: single-card run {s:.1f} s")
    se_check("four single", idx, single, batch, sim, ref, 0.98)
    ref = sam_records(ref, idx, batch)
    meshes = {
        "data4": make_mesh(4),
        "data2_index2": Mesh(np.array(devs).reshape(2, 2),
                             axis_names=("data", "index")),
    }
    for name, mesh in meshes.items():
        al = Aligner.build(idx, _opts(), mode="full", mesh=mesh)
        cols, s = timed(se_run, jax, al, idx, batch)
        log(f"four: {name} mesh {dict(mesh.shape)} run (compile + run) "
            f"{s:.1f} s")
        assert_same_records(f"four {name} vs single card", ref,
                            sam_records(cols, idx, batch), batch.names)
        s2 = timed(lambda: jax.block_until_ready(al.device_regions(batch)))[1]
        log(f"four: {name} device step {s2 * 1e3:.1f} ms")
        out["stats"][f"{name}_device_ms"] = round(s2 * 1e3, 1)
    peaks = peak_bytes(jax)
    log(f"four: peak_bytes_in_use per device {peaks}")
    assert all(p > 0 for p in peaks[:4]), "a device did no work"


def result_line(info: dict) -> str:
    """The last stdout line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU mesh path")
    args = p.parse_args(argv)

    jax = bench.require_gpu()
    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    info = bench.device_info(jax)
    log(f"card: {'; '.join(bench.card_line().splitlines())}")
    log(f"device: {info}; compile cache {cache}")
    out = {"phases": {}, "stats": {}}
    (four_cards if args.four else one_card)(jax, out)
    log(f"summary: {json.dumps(out)}")
    print(result_line(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
