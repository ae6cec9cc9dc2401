"""Long-read (>= ~900 bp) device-path agreement: the windowed seed-SW
filter (kernels/seedsw.py == oracle flt_chained_seeds) runs ON DEVICE,
so 1-3 kb reads finalize through the batched pipeline instead of
collapsing to the scalar per-read oracle."""

import numpy as np
import pytest

import jax

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.align.pipeline import Aligner
from bioseqdb_tpu.cpu import oracle as O
from bioseqdb_tpu.cpu.ksw import cigar_to_string
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

LUT = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i
LUT[ord("N")] = 4
enc = lambda s: LUT[np.frombuffer(s.encode(), np.uint8)]


@pytest.fixture(scope="module")
def setup():
    g = simulate_genome(120_000, seed=51)
    idx = build_index([("ref", g)])
    return g, idx


def run_and_compare(setup_t, reads, opt=None, allow_overflow=0):
    g, idx = setup_t
    opt = opt or AlignOptions()
    al = Aligner.build(idx, opt, mode="full")
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    out = jax.device_get(al.device_regions(batch))
    novf = int(np.asarray(out["overflow"])[: batch.n].sum())
    # the point of the device filter: long reads stay on device
    assert novf <= allow_overflow, f"{novf} long reads overflowed"
    results = al.align_batch(batch)
    for i, r in enumerate(reads):
        q = enc(r)
        want = O.align_read(idx, opt, q, rand_id=i,
                            min_score=opt.min_score, all_hits=True)
        got = results[i].hits
        w = [(a.pos, a.is_rev, cigar_to_string(a.cigar), a.score, a.mapq,
              a.NM, bool(a.flag & 0x100)) for a in want]
        gg = [(h.ref_begin, h.is_reverse, h.cigar, h.score, h.mapq, h.nm,
               h.is_secondary) for h in got]
        assert gg == w, (i, gg, w)
    return novf


def test_filter_gate_matches_oracle():
    # the static/per-read activation must mirror the oracle's guard
    from bioseqdb_tpu.kernels.seedsw import possibly_active

    opt = AlignOptions()
    for L in (100, 300, 899, 1200, 3000):
        assert possibly_active(opt.min_chain_weight, L) == \
            O.seed_sw_filter_active(opt, L), L


def test_longread_1200_mutated(setup):
    g, _ = setup
    sim = simulate_reads(g, 6, read_len=1200, sub_rate=0.01, seed=52)
    run_and_compare(setup, list(sim.reads))


def test_longread_2000_exact(setup):
    g, _ = setup
    sim = simulate_reads(g, 4, read_len=2000, sub_rate=0.0, seed=53)
    run_and_compare(setup, list(sim.reads))


def test_longread_mixed_lengths(setup):
    # a batch mixing short reads (filter inactive per-read) and long
    # ones (active) through one program
    g, _ = setup
    s1 = simulate_reads(g, 3, read_len=1500, sub_rate=0.01, seed=54)
    s2 = simulate_reads(g, 3, read_len=150, sub_rate=0.01, seed=55)
    run_and_compare(setup, list(s1.reads) + list(s2.reads))
