"""Command-line interface.

Covers both reference entry points with one tool:
- ``index`` / ``align``: the engine proper (the role the SQL functions
  nuclseq_search_bwa / nuclseq_multi_search_bwa played,
  extension.cpp:311-378), bwa-style invocation.
- ``import``: the bioseqdb-import analogue (bioseqdb-import/main.cpp) —
  streams FASTA/FASTQ into packed .npz read-batch shards instead of one
  libpq INSERT per sequence.

Usage:
    python -m bioseqdb_tpu index ref.fa -o ref.idx
    python -m bioseqdb_tpu align ref.idx reads.fq -o out.sam
    python -m bioseqdb_tpu import reads.fq -o shards/ --batch-size 65536
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _cmd_index(args) -> int:
    from bioseqdb_tpu.index.builder import build_index_from_fasta

    t0 = time.time()
    idx = build_index_from_fasta(args.fasta, sa_interval=args.sa_interval)
    idx.save(args.output)
    print(
        f"[bioseqdb-tpu] indexed {idx.n_refs} sequence(s), {idx.l_pac} bases "
        f"in {time.time() - t0:.2f}s -> {args.output}",
        file=sys.stderr,
    )
    return 0


def _cmd_align(args) -> int:
    import contextlib

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.index.fmindex import FMIndex
    from bioseqdb_tpu.io.batch import pack_reads_from_file
    from bioseqdb_tpu.sam.emit import emit_sam, sam_header
    from bioseqdb_tpu.utils.compile_cache import enable_compile_cache
    from bioseqdb_tpu.utils.profiling import StageTimer, device_trace

    enable_compile_cache()

    idx = FMIndex.load(args.index)
    opts = AlignOptions(
        min_seed_len=args.min_seed_len,
        max_occ=args.max_occ,
        match_score=args.match_score,
        mismatch_penalty=args.mismatch_penalty,
        o_del=args.open_del, e_del=args.ext_del,
        o_ins=args.open_ins, e_ins=args.ext_ins,
        pen_clip5=args.clip5, pen_clip3=args.clip3,
        zdrop=args.zdrop, bandwidth=args.bandwidth,
        min_score=args.min_score,
    )
    aligner = Aligner.build(idx, opts, mode=args.mode)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    timer = StageTimer()
    trace = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.time()
    n = 0
    try:
        out.write(sam_header(idx, program_args=" ".join(sys.argv[1:]),
                             read_group=args.rg))
        if args.mate:
            from bioseqdb_tpu.sam.emit import emit_sam_pair_columns

            it1 = pack_reads_from_file(args.reads, batch_size=args.batch_size)
            it2 = pack_reads_from_file(args.mate, batch_size=args.batch_size)
            with trace:
                for b1, b2 in zip(it1, it2):
                    with timer.stage("align_pe", b1.n + b2.n):
                        c1, c2 = aligner.align_pairs_columns(b1, b2)
                        s1 = [b1.read_text(i) for i in range(b1.n)]
                        s2 = [b2.read_text(i) for i in range(b2.n)]
                        out.write(emit_sam_pair_columns(
                            c1, c2, idx, b1, b2, header=False,
                            seqs1=s1, seqs2=s2, read_group=args.rg))
                    n += b1.n + b2.n
        elif args.mode == "exact":
            with trace:
                for batch in pack_reads_from_file(
                    args.reads, batch_size=args.batch_size
                ):
                    with timer.stage("align", batch.n):
                        results = aligner.align_batch(batch)
                        seqs = [batch.read_text(i) for i in range(batch.n)]
                        out.write(emit_sam(results, idx, seqs, batch.qualities,
                                           header=False,
                                           read_group=args.rg))
                    n += batch.n
        else:
            # double-buffered: device compute of batch k+1 is dispatched
            # (async) before the host finalizes batch k
            with trace:
                pending = prev_batch = None
                for batch in pack_reads_from_file(
                    args.reads, batch_size=args.batch_size
                ):
                    with timer.stage("device_dispatch"):
                        cur = aligner.device_regions(batch)
                    if pending is not None:
                        n += _drain(aligner, idx, prev_batch, pending, out,
                                    timer, args.rg)
                    pending, prev_batch = cur, batch
                if pending is not None:
                    n += _drain(aligner, idx, prev_batch, pending, out,
                                timer, args.rg)
    finally:
        if out is not sys.stdout:
            out.close()
    dt = time.time() - t0
    timer.report()
    print(
        f"[bioseqdb-tpu] aligned {n} reads in {dt:.2f}s "
        f"({n / max(dt, 1e-9):,.0f} reads/s)",
        file=sys.stderr,
    )
    return 0


def _drain(aligner, idx, batch, pending, out, timer,
           read_group=None) -> int:
    """Finalize one batch and write its SAM records. A failure raises:
    a batch is never skipped."""
    import jax

    from bioseqdb_tpu.align.columns import finalize_columns
    from bioseqdb_tpu.sam.emit import emit_sam_columns

    with timer.stage("device_wait", batch.n):
        regions = jax.device_get(jax.block_until_ready(pending))
    with timer.stage("finalize", batch.n):
        regions = aligner.absorb_overflow(batch, regions)
        cols = finalize_columns(idx, aligner.options, batch, regions)
        seqs = [batch.read_text(i) for i in range(batch.n)]
        out.write(emit_sam_columns(cols, idx, batch, header=False, seqs=seqs,
                                   read_group=read_group))
    return batch.n


def _cmd_import(args) -> int:
    """Bulk ingest with a per-shard manifest so interrupted imports
    resume (SURVEY.md §5: batch-granular recovery — unlike the
    reference's all-or-nothing single transaction, main.cpp:46,73)."""
    import json

    import numpy as np

    from bioseqdb_tpu.io.batch import pack_reads_from_file

    os.makedirs(args.output, exist_ok=True)
    manifest_path = os.path.join(args.output, "manifest.json")
    done: dict = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            done = json.load(fh).get("shards", {})
        print(f"[bioseqdb-tpu] resuming: {len(done)} shard(s) present",
              file=sys.stderr)
    n = 0
    shards = dict(done)
    for i, batch in enumerate(
        pack_reads_from_file(args.reads, batch_size=args.batch_size)
    ):
        name = f"shard{i:05d}.npz"
        path = os.path.join(args.output, name)
        if name in done and os.path.exists(path):
            n += batch.n
            continue
        # np.savez appends ".npz" when the name lacks it — account for that
        tmp = path + ".tmp"
        np.savez_compressed(
            tmp, codes=batch.codes, lens=batch.lens,
            names=np.array(batch.names),
        )
        os.replace(tmp + ".npz", path)
        shards[name] = batch.n
        with open(manifest_path, "w") as fh:
            json.dump({"source": str(args.reads), "shards": shards}, fh)
        n += batch.n
        print(f"[bioseqdb-tpu] wrote {name} ({batch.n} reads)", file=sys.stderr)
    print(f"[bioseqdb-tpu] imported {n} reads", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bioseqdb-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build an FM-index from FASTA")
    pi.add_argument("fasta")
    pi.add_argument("-o", "--output", required=True)
    pi.add_argument("--sa-interval", type=int, default=None)
    pi.set_defaults(fn=_cmd_index)

    pa = sub.add_parser("align", help="align FASTA/FASTQ reads against an index")
    pa.add_argument("index")
    pa.add_argument("reads")
    pa.add_argument("--mate", help="mate FASTA/FASTQ for paired-end alignment")
    pa.add_argument("-o", "--output", default="-")
    # moderate batches compile fast and pipeline well with finalize
    pa.add_argument("--batch-size", type=int, default=2048)
    # scoring/heuristic knobs mirroring bwa mem's flags and the reference
    # SQL bwa_options fields (bioseqdb--0.0.0.sql:160-194)
    pa.add_argument("-k", "--min-seed-len", type=int, default=19)
    pa.add_argument("-c", "--max-occ", type=int, default=None)
    pa.add_argument("-A", "--match-score", type=int, default=1)
    pa.add_argument("-B", "--mismatch-penalty", type=int, default=4)
    pa.add_argument("-O", "--open-del", type=int, default=6)
    pa.add_argument("-E", "--ext-del", type=int, default=1)
    pa.add_argument("--open-ins", type=int, default=6)
    pa.add_argument("--ext-ins", type=int, default=1)
    pa.add_argument("-L5", "--clip5", type=int, default=5)
    pa.add_argument("-L3", "--clip3", type=int, default=5)
    pa.add_argument("-d", "--zdrop", type=int, default=100)
    pa.add_argument("-w", "--bandwidth", type=int, default=100)
    pa.add_argument("-T", "--min-score", type=int, default=30)
    pa.add_argument("-R", "--rg", help="@RG header line (\\t-separated, bwa -R style)")
    pa.add_argument(
        "--mode", choices=["full", "exact"], default="full",
                    help="full BWA-MEM pipeline or the exact-match fast path (exact: fast path with approximate MAPQ=60/0 and no NM/MD)")
    pa.add_argument("--cpu", action="store_true", help="force the CPU backend")
    pa.add_argument("--profile", help="capture a jax.profiler device trace here")
    pa.set_defaults(fn=_cmd_align)

    pm = sub.add_parser("import", help="pack reads into .npz shards (bulk ingest)")
    pm.add_argument("reads")
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("--batch-size", type=int, default=65536)
    pm.set_defaults(fn=_cmd_import)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
