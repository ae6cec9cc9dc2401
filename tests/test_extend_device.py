"""Device extension orchestration vs the oracle's chain2aln regions."""

import numpy as np
import pytest

import jax.numpy as jnp

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.cpu import oracle as O
from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.kernels import fm as kfm
from bioseqdb_tpu.kernels.chain import chain_seeds, filter_chains, resolve_seeds
from bioseqdb_tpu.kernels.extend import extend_all
from bioseqdb_tpu.kernels.seed import collect_seeds_device
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads

LUT = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i
LUT[ord("N")] = 4
enc = lambda s: LUT[np.frombuffer(s.encode(), np.uint8)]


@pytest.fixture(scope="module")
def setup():
    core = simulate_genome(25_000, seed=31)
    rep = simulate_genome(400, seed=32)
    g = core[:8000] + rep + core[8000:16000] + rep + core[16000:]
    idx = build_index([("ref", g)])
    return g, idx, kfm.FMDevice.from_host(idx)


def run_device(fm, idx, reads_codes, opt, W=160, sw_sort=False):
    B = len(reads_codes)
    codes = np.full((B, W), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for i, rc in enumerate(reads_codes):
        codes[i, : len(rc)] = rc
        lens[i] = len(rc)
    codes = jnp.asarray(codes)
    lens_j = jnp.asarray(lens)
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    mems = collect_seeds_device(
        fm, codes, lens_j, min_seed_len=opt.min_seed_len, split_len=split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
    )
    seeds = resolve_seeds(fm, mems["mems"], mems["n_mem"],
                          max_occ=opt.resolve_max_occ(idx.n_refs), max_seeds=64)
    chains = chain_seeds(fm, seeds, max_chains=16, bandwidth=opt.bandwidth,
                         max_chain_gap=opt.max_chain_gap)
    flt = filter_chains(chains, seeds, mask_level=opt.mask_level,
                        chain_drop_ratio=opt.chain_drop_ratio,
                        min_chain_weight=opt.min_chain_weight,
                        min_seed_len=opt.min_seed_len,
                        max_chain_gap=opt.max_chain_gap)
    mat = jnp.asarray(fill_scmat(opt.match_score, opt.mismatch_penalty).astype(np.int32))
    from bioseqdb_tpu.kernels.extend import pack_doubled_rows
    pac_dev = jnp.asarray(pack_doubled_rows(np.asarray(idx.pac)))
    out = extend_all(
        fm, pac_dev, codes, lens_j, seeds, chains, flt, mat,
        match_score=opt.match_score, mismatch_penalty=opt.mismatch_penalty,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        bandwidth=opt.bandwidth, zdrop=opt.zdrop,
        pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
        sw_sort=sw_sort,
    )
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {k2: np.asarray(v2) for k2, v2 in v.items()})
            for k, v in out.items()}


def oracle_regions(idx, rc, opt):
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    chains = O.mem_chain(idx, opt, rc)
    chains = O.chain_flt(opt, chains)
    regs = []
    for c in chains:
        O.chain2aln(idx, opt, rc, c, regs, mat)
    return regs


def compare(setup_t, reads, opt=None):
    g, idx, fm = setup_t
    opt = opt or AlignOptions()
    rcs = [enc(r) for r in reads]
    out = run_device(fm, idx, rcs, opt)
    assert not out["overflow"].any()
    for i, rc in enumerate(rcs):
        want = oracle_regions(idx, rc, opt)
        n = int(out["n_regs"][i])
        got = [
            tuple(int(out["regs"][f][i, r]) for f in
                  ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedlen0", "seedcov"))
            for r in range(n)
        ]
        wanted = [
            (w.rb, w.re, w.qb, w.qe, w.score, w.truesc, w.w, w.seedlen0, w.seedcov)
            for w in want
        ]
        assert got == wanted, (i, got, wanted)


def test_unique_reads(setup):
    g, idx, fm = setup
    sim = simulate_reads(g, 16, read_len=120, seed=1)
    compare(setup, sim.reads)


def test_mismatched_reads(setup):
    g, idx, fm = setup
    sim = simulate_reads(g, 24, read_len=150, sub_rate=0.04, seed=2)
    compare(setup, sim.reads)


def test_repeat_reads(setup):
    g, idx, fm = setup
    reads = [g[8000 + off : 8000 + off + 120] for off in (0, 100, 250)]
    compare(setup, reads)


def test_sorted_lanes_match_unsorted(setup):
    """The work-sorted lane permutation around each SW call
    (kernels/extend.py sw_with_retry_local, on with the CUDA kernel) is
    unobservable: with the XLA kernel, sorted and unsorted lanes give
    equal regions."""
    g, idx, fm = setup
    sim = simulate_reads(g, 12, read_len=120, sub_rate=0.04, seed=5)
    rcs = [enc(r) for r in sim.reads]
    opt = AlignOptions()
    ref = run_device(fm, idx, rcs, opt)
    got = run_device(fm, idx, rcs, opt, sw_sort=True)
    assert (got["n_regs"] == ref["n_regs"]).all()
    assert (got["overflow"] == ref["overflow"]).all()
    for f in ref["regs"]:
        assert (got["regs"][f] == ref["regs"][f]).all(), f


def test_indel_and_clip_reads(setup):
    g, idx, fm = setup
    junk = "".join("ACGT"[i % 4] for i in range(25))
    reads = [
        g[5000:5060] + g[5063:5123],
        g[6000:6050] + "ACGTA" + g[6050:6110],
        junk + g[3000:3100],
        g[3000:3100] + junk,
    ]
    compare(setup, reads)


def test_chimeric_reads(setup):
    g, idx, fm = setup
    reads = [
        g[1000:1075] + g[20000:20075],
        g[3000:3080] + g[12000:12070],
    ]
    compare(setup, reads)


def test_edge_reads(setup):
    g, idx, fm = setup
    reads = [g[:50], g[-50:], g[100:140]]
    compare(setup, reads)
