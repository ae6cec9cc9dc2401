"""Benchmark: 150 bp reads aligned per second on one NVIDIA GPU.

Measures the full BWA-MEM pipeline (seeding, chaining and banded-SW
extension on the device; dedup, MAPQ, CIGAR and columns on the host)
in three legs:

- SE: an E. coli-scale (4.6 Mb) synthetic index, 16,384 reads per
  batch at 1% substitutions (BASELINE.md config 2);
- PE: the same index, 8,192 pairs per batch (insert 400 +- 40) through
  the fused pair dispatch;
- chr20: a 64 Mb synthetic index, PE as above (BASELINE.md config 3).

Each leg warms every program first (compile is reported as set-up),
then runs passes of double-buffered batches: batch k+1 is dispatched
before batch k is finalized, and each device result is awaited with
``block_until_ready``. A pass is scored by its median batch time; the
headline is the median over passes. Every leg checks its outputs:
reads at truth (>= 98% SE, >= 95% PE read 1) and every read off truth
classified against the host oracle (cpu/oracle.py), with zero
device-vs-oracle disagreements. Any failure fails the run.

Runs only on a GPU. Prints the device on stderr lines and ONE JSON line
last on stdout (well under 2,000 characters).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _log(*a):
    print("[bench]", *a, file=sys.stderr, flush=True)


def require_gpu():
    """The JAX module, after checking that its default device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX's default device is "
                         f"{dev.platform} ({dev.device_kind})")
    return jax


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_info(jax) -> dict:
    d = jax.devices()[0]
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))


def truth_mask(cols, positions, strands=None):
    n = len(positions)
    ok = cols.mapped[:n] & (cols.pos[:n] == positions)
    if strands is not None:
        ok &= cols.is_rev[:n] == np.asarray(strands).astype(bool)
    return ok


def _agrees(cols, i, prim) -> bool:
    if prim is None:
        return not cols.mapped[i]
    return (bool(cols.mapped[i]) and int(cols.pos[i]) == prim.pos
            and bool(cols.is_rev[i]) == bool(prim.is_rev)
            and int(cols.score[i]) == prim.score)


def classify_se(idx, opt, batch, cols, rows) -> dict:
    """Classify single-end reads off simulated truth against the host
    oracle: a primary record that differs from the oracle's is a
    device_ne_oracle; oracle-agreeing ones are legitimate BWA-MEM
    outcomes (repeat placement, clipped placement shift, score drop)."""
    from bioseqdb_tpu.cpu import oracle as O

    classes = dict(oracle_agree_mapped=0, oracle_agree_unmapped=0,
                   device_ne_oracle=0)
    for i in map(int, rows):
        q = np.asarray(batch.codes)[i, : batch.lens[i]].astype(np.uint8)
        alns = O.align_read(idx, opt, q, rand_id=i, min_score=opt.min_score,
                            all_hits=True)
        prim = next((a for a in alns if not a.flag & 0x100), None)
        if not _agrees(cols, i, prim):
            classes["device_ne_oracle"] += 1
        elif prim is None:
            classes["oracle_agree_unmapped"] += 1
        else:
            classes["oracle_agree_mapped"] += 1
    return classes


def classify_pe(idx, opt, b1, out1, b2, out2, c1, rows) -> dict:
    """classify_se for read 1 of pairs: the oracle record is the pair
    finalize (mate rescue, pairing, MAPQ) applied to the host oracle's
    regions for both ends (cpu/oracle.py mem_align1), under the batch's
    insert-size statistics."""
    from bioseqdb_tpu.align.paired import _pair_slow_one, _pairs_prelude
    from bioseqdb_tpu.cpu import oracle as O

    _, mat, _, _, pes, _, _ = _pairs_prelude(idx, opt, b1, out1, b2, out2)
    classes = dict(oracle_agree_mapped=0, oracle_agree_unmapped=0,
                   device_ne_oracle=0)
    for i in map(int, rows):
        q1 = np.asarray(b1.codes)[i, : b1.lens[i]].astype(np.uint8)
        q2 = np.asarray(b2.codes)[i, : b2.lens[i]].astype(np.uint8)
        r1 = O.mem_align1(idx, opt, q1, rand_id=i)
        r2 = O.mem_align1(idx, opt, q2, rand_id=(1 << 20) + i)
        res1, _ = _pair_slow_one(idx, opt, mat, pes, b1.names[i], q1, r1,
                                 q2, r2, rid1=i, rid2=(1 << 20) + i)
        prim = res1.hits[0] if res1.hits else None  # primary first
        if prim is None:
            agree = not c1.mapped[i]
        else:
            agree = (bool(c1.mapped[i]) and int(c1.pos[i]) == prim.ref_begin
                     and bool(c1.is_rev[i]) == bool(prim.is_reverse)
                     and int(c1.score[i]) == prim.score)
        key = ("device_ne_oracle" if not agree else
               "oracle_agree_mapped" if prim is not None
               else "oracle_agree_unmapped")
        classes[key] += 1
    return classes


def _passes(name, one_pass, reads_per_batch, n_passes):
    """Run the passes; returns (headline reads/s, per-pass reads/s, the
    last pass's results)."""
    rates, last = [], None
    for p in range(n_passes):
        bt, last = one_pass()
        med = statistics.median(bt)
        rates.append(reads_per_batch / med)
        _log(f"{name} pass {p + 1}: median {med * 1e3:.1f} ms/batch = "
             f"{rates[-1]:,.0f} reads/s (batches "
             f"{' '.join(f'{t * 1e3:.1f}' for t in bt)} ms)")
    return statistics.median(rates), rates, last


def bench_se(jax, idx, genome, batch_size, n_batches, n_passes):
    from bioseqdb_tpu.align.columns import finalize_columns
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_reads

    al = Aligner.build(idx, AlignOptions(), mode="full")
    sims = [simulate_reads(genome, batch_size, read_len=150, sub_rate=0.01,
                           seed=100 + k) for k in range(n_batches)]
    batches = [pack_reads(s.reads, s.names) for s in sims]

    t0 = time.time()
    out = al.absorb_overflow(batches[0],
                             jax.device_get(al.device_regions(batches[0])))
    finalize_columns(idx, al.options, batches[0], out)
    setup_s = time.time() - t0
    _log(f"SE compile + first batch: {setup_s:.1f} s")

    def one_pass():
        bt, results = [], []
        t0 = time.perf_counter()
        pending = al.device_regions(batches[0])
        for k in range(n_batches):
            nxt = (al.device_regions(batches[k + 1])
                   if k + 1 < n_batches else None)
            out = jax.device_get(jax.block_until_ready(pending))
            out = al.absorb_overflow(batches[k], out)
            results.append(finalize_columns(idx, al.options, batches[k], out))
            t1 = time.perf_counter()
            bt.append(t1 - t0)
            t0 = t1
            pending = nxt
        return bt, results

    rps, rates, results = _passes("SE", one_pass, batch_size, n_passes)
    total = ok = novf = 0
    classes = dict(oracle_agree_mapped=0, oracle_agree_unmapped=0,
                   device_ne_oracle=0)
    for cols, sim, batch in zip(results, sims, batches):
        at = truth_mask(cols, sim.positions, sim.strands)
        total += len(at)
        ok += int(at.sum())
        novf += len(cols.extra)
        for k, v in classify_se(idx, al.options, batch, cols,
                                np.flatnonzero(~at)).items():
            classes[k] += v
    _log(f"SE truth {ok}/{total}; slow-path reads {novf}; {classes}")
    if ok < 0.98 * total or classes["device_ne_oracle"]:
        raise SystemExit(f"SE correctness check failed: truth {ok}/{total}, "
                         f"{classes}")
    return al, dict(se_reads_s=round(rps), se_pass_rps=[round(r) for r in rates],
                    se_setup_s=round(setup_s, 1), se_truth=ok, se_total=total,
                    se_slow_path=novf,
                    se_device_ne_oracle=classes["device_ne_oracle"])


def bench_pe(jax, idx, genome, al, name, pairs, n_batches, n_passes, seed0):
    from bioseqdb_tpu.align.paired import finalize_pairs_columns
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_pairs

    sims, batches = [], []
    for k in range(n_batches):
        s1, s2, _ = simulate_pairs(genome, pairs, read_len=150, sub_rate=0.01,
                                   insert_mean=400, insert_std=40,
                                   seed=seed0 + k)
        sims.append(s1)
        batches.append((pack_reads(s1.reads, s1.names),
                        pack_reads(s2.reads, s2.names)))

    def finish(k, pending):
        b1, b2 = batches[k]
        o1, o2 = jax.device_get(jax.block_until_ready(pending))
        o1, o2 = al.absorb_overflow_pair(b1, o1, b2, o2)
        return o1, o2, finalize_pairs_columns(idx, al.options, b1, o1, b2, o2)

    t0 = time.time()
    finish(0, al.device_regions_pair(*batches[0]))
    setup_s = time.time() - t0
    _log(f"{name} compile + first pair batch: {setup_s:.1f} s")

    def one_pass():
        bt, outs = [], []
        t0 = time.perf_counter()
        pending = al.device_regions_pair(*batches[0])
        for k in range(n_batches):
            nxt = (al.device_regions_pair(*batches[k + 1])
                   if k + 1 < n_batches else None)
            outs.append(finish(k, pending))
            t1 = time.perf_counter()
            bt.append(t1 - t0)
            t0 = t1
            pending = nxt
        return bt, outs

    rps, rates, outs = _passes(name, one_pass, 2 * pairs, n_passes)
    ok = proper = ne = 0
    for (o1, o2, (c1, _)), s1, (b1, b2) in zip(outs, sims, batches):
        at = truth_mask(c1, s1.positions)
        ok += int(at.sum())
        proper += int((c1.pe_flag[:pairs] & 0x2 > 0).sum())
        ne += classify_pe(idx, al.options, b1, o1, b2, o2, c1,
                          np.flatnonzero(~at))["device_ne_oracle"]
    tot = pairs * n_batches
    _log(f"{name} truth (read 1) {ok}/{tot}; proper {100 * proper / tot:.1f}%;"
         f" device_ne_oracle {ne}")
    if ok < 0.95 * tot or ne:
        raise SystemExit(f"{name} correctness check failed: truth {ok}/{tot},"
                         f" device_ne_oracle {ne}")
    return {f"{name}_reads_s": round(rps),
            f"{name}_pass_rps": [round(r) for r in rates],
            f"{name}_setup_s": round(setup_s, 1), f"{name}_truth": ok,
            f"{name}_total_pairs": tot,
            f"{name}_proper_pct": round(100 * proper / tot, 1),
            f"{name}_device_ne_oracle": ne}


def main() -> int:
    jax = require_gpu()
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache
    from bioseqdb_tpu.utils.sim import simulate_genome

    enable_compile_cache()
    info = device_info(jax)
    _log(f"device {info}; card {card_line()}")
    batch = int(os.environ.get("BST_BENCH_BATCH", 16384))
    n_passes = int(os.environ.get("BST_BENCH_PASSES", 3))

    t0 = time.time()
    genome = simulate_genome(4_600_000, seed=1)
    idx = build_index([("ecoli", genome)])
    _log(f"E. coli-scale index built in {time.time() - t0:.1f} s")
    al, stats = bench_se(jax, idx, genome, batch, 6, n_passes)
    stats.update(bench_pe(jax, idx, genome, al, "pe", batch // 2, 3,
                          n_passes, seed0=700))
    stats["pe_se_ratio"] = round(stats["pe_reads_s"] / stats["se_reads_s"], 3)
    del al

    t0 = time.time()
    genome = simulate_genome(64_000_000, seed=20)
    idx = build_index([("chr20", genome)])
    _log(f"chr20-scale index built in {time.time() - t0:.1f} s")
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner

    al = Aligner.build(idx, AlignOptions(), mode="full")
    stats.update(bench_pe(jax, idx, genome, al, "chr20_pe", batch // 2, 3,
                          n_passes, seed0=900))

    print(json.dumps({
        "metric": "150bp reads/s, full BWA-MEM pipeline, E. coli-scale SE",
        "value": stats["se_reads_s"], "unit": "reads/s", "device": info,
        **stats,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
