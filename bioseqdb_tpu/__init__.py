"""bioseqdb_tpu — a short-read alignment engine in JAX.

A from-scratch JAX/XLA re-design of the capability of
unneon/bioseqdb (a Postgres extension wrapping libbwa/htslib): BWA-MEM
style mapping of query reads against an indexed reference, exposed as an
``align(reads, index)`` API plus bulk FASTA/FASTQ ingest, with the
FM-index held in packed int32 device arrays and the seeding/chaining/
extension stages running as batched device programs (an NVIDIA GPU;
the CPU backend for tests).

Package map (SURVEY.md §7):
- ``seq``     sequence codec (NUCLSEQ replacement)
- ``io``      FASTA/FASTQ ingest -> packed batches (bioseqdb-import analogue)
- ``index``   FM-index build (native SA-IS) + device array layout + serialization
- ``kernels`` device ops: Occ/rank gathers, SMEM seeding, chaining, banded SW
- ``align``   the align() pipeline + options
- ``sam``     CIGAR/SAM emission
- ``cpu``     clean-room CPU oracle (bwa-mem semantics) used as test oracle
- ``dist``    mesh setup, data-parallel sharding, index sharding
"""

from bioseqdb_tpu.seq.codec import (
    ALLOWED_NUCLEOTIDES,
    Sequence,
    nuclseq_in,
)
from bioseqdb_tpu.align.options import AlignOptions, bwa_opts

__version__ = "0.1.0"


def __getattr__(name):
    # heavier entry points load lazily so `import bioseqdb_tpu` stays
    # jax-free for codec-only use
    lazy = {
        "Aligner": ("bioseqdb_tpu.align.pipeline", "Aligner"),
        "align": ("bioseqdb_tpu.align.pipeline", "align"),
        "FMIndex": ("bioseqdb_tpu.index.fmindex", "FMIndex"),
        "build_index": ("bioseqdb_tpu.index.builder", "build_index"),
        "build_index_from_fasta": ("bioseqdb_tpu.index.builder", "build_index_from_fasta"),
        "search": ("bioseqdb_tpu.api", "search"),
        "multi_search": ("bioseqdb_tpu.api", "multi_search"),
        "SearchResult": ("bioseqdb_tpu.api", "SearchResult"),
        "emit_sam": ("bioseqdb_tpu.sam.emit", "emit_sam"),
        "pack_reads": ("bioseqdb_tpu.io.batch", "pack_reads"),
        "read_fasta": ("bioseqdb_tpu.io.fasta", "read_fasta"),
        "read_fastq": ("bioseqdb_tpu.io.fasta", "read_fastq"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'bioseqdb_tpu' has no attribute {name!r}")


__all__ = [
    "ALLOWED_NUCLEOTIDES",
    "Sequence",
    "nuclseq_in",
    "AlignOptions",
    "bwa_opts",
    "Aligner",
    "align",
    "FMIndex",
    "build_index",
    "build_index_from_fasta",
    "search",
    "multi_search",
    "SearchResult",
    "emit_sam",
    "pack_reads",
    "read_fasta",
    "read_fastq",
    "__version__",
]
