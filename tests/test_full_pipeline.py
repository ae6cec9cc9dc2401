"""End-to-end full-pipeline agreement: device align == host oracle.

This is the round-trip gate for BASELINE.md config 2 scope: reads with
mismatches/indels/clips/repeats must produce identical final records
(position, strand, CIGAR, score, MAPQ, NM, flags) through the batched
device pipeline + host finalize as through the pure host oracle.
"""

import numpy as np
import pytest

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
    core = simulate_genome(25_000, seed=41)
    rep = simulate_genome(400, seed=42)
    g = core[:8000] + rep + core[8000:16000] + rep + core[16000:]
    idx = build_index([("ref", g)])
    return g, idx


def compare(setup_t, reads, opt=None):
    g, idx = setup_t
    opt = opt or AlignOptions()
    aligner = Aligner.build(idx, opt, mode="full")
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    results = aligner.align_batch(batch)
    for i, r in enumerate(reads):
        q = enc(r)
        want = O.align_read(idx, opt, q, rand_id=i,
                            min_score=opt.min_score, all_hits=True)
        got = results[i].hits
        w = [
            (a.pos, a.is_rev, cigar_to_string(a.cigar), a.score, a.mapq,
             a.NM, bool(a.flag & 0x100))
            for a in want
        ]
        gg = [
            (h.ref_begin, h.is_reverse, h.cigar, h.score, h.mapq, h.nm,
             h.is_secondary)
            for h in got
        ]
        assert gg == w, (i, gg, w)


def test_exact_reads(setup):
    g, idx = setup
    sim = simulate_reads(g, 16, read_len=100, seed=1)
    compare(setup, sim.reads)


def test_mismatched_reads(setup):
    g, idx = setup
    sim = simulate_reads(g, 32, read_len=150, sub_rate=0.04, seed=2)
    compare(setup, sim.reads)


def test_heavily_mutated_reads(setup):
    g, idx = setup
    sim = simulate_reads(g, 16, read_len=150, sub_rate=0.10, seed=3)
    compare(setup, sim.reads)


def test_indel_and_clip_reads(setup):
    g, idx = setup
    junk = "".join("ACGT"[i % 4] for i in range(25))
    reads = [
        g[5000:5060] + g[5063:5123],
        g[6000:6050] + "ACGTA" + g[6050:6110],
        junk + g[3000:3100],
        g[3000:3100] + junk,
        g[2000:2060] + g[2070:2130],   # 10bp deletion
    ]
    compare(setup, reads)


def test_repeat_reads_secondary(setup):
    g, idx = setup
    reads = [g[8000 + off : 8000 + off + 120] for off in (0, 100, 250)]
    compare(setup, reads)


def test_chimeric_reads(setup):
    g, idx = setup
    reads = [
        g[1000:1075] + g[20000:20075],
        g[3000:3080] + g[12000:12070],
    ]
    compare(setup, reads)


def test_junk_and_n_reads(setup):
    g, idx = setup
    rng = np.random.default_rng(4)
    junky = "".join("ACGT"[c] for c in rng.integers(0, 4, 120))
    with_n = g[4000:4060] + "N" + g[4061:4120]
    compare(setup, [junky, with_n, "N" * 50])


def test_multi_ref(setup):
    g, _ = setup
    a, b = g[:6000], g[10000:17000]
    idx2 = build_index([(5, "chrA", a), (9, "chrB", b)])
    sim_a = simulate_reads(a, 6, read_len=120, seed=5)
    sim_b = simulate_reads(b, 6, read_len=120, seed=6)
    opt = AlignOptions()
    aligner = Aligner.build(idx2, opt, mode="full")
    reads = sim_a.reads + sim_b.reads
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    results = aligner.align_batch(batch)
    for i, res in enumerate(results):
        want = O.align_read(idx2, opt, enc(reads[i]), rand_id=i)
        assert len(res.hits) == len(want)
        prim = res.primary
        truth_name = "chrA" if i < 6 else "chrB"
        assert prim.ref_name == truth_name
        assert prim.ref_id == (5 if i < 6 else 9)


def test_bwa_style_output_with_xa_tag(setup):
    # primary-only mode folds alternates into the primary's XA tag
    g, idx = setup
    from bioseqdb_tpu.align.finalize import finalize_batch
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.sam.emit import emit_sam
    import jax

    read = g[8000:8120]  # inside the duplicated repeat: two equal hits
    al = Aligner.build(idx, AlignOptions(), mode="full")
    batch = pack_reads([read], ["rep"])
    out = jax.device_get(al.device_regions(batch))
    res = finalize_batch(idx, al.options, batch, out, all_hits=False)[0]
    assert len(res.hits) == 1
    h = res.hits[0]
    assert h.is_primary and h.xa
    assert h.xa.count(";") == 1
    alt = h.xa.split(",")
    assert alt[0] == "ref" and alt[1][0] in "+-"
    sam = emit_sam([res], idx, [read], header=False)
    assert "XA:Z:" in sam


def test_chimeric_supplementary_flags(setup):
    g, idx = setup
    from bioseqdb_tpu.align.pipeline import align as align_fn
    from bioseqdb_tpu.sam.emit import emit_sam

    read = g[1000:1075] + g[20000:20075]
    res = align_fn([read], idx)[0]
    prims = [h for h in res.hits if not h.is_secondary]
    assert len(prims) == 2
    assert not prims[0].is_supplementary and prims[1].is_supplementary
    sam = emit_sam([res], idx, [read], header=False)
    flags = [int(l.split("\t")[1]) for l in sam.strip().split("\n")]
    assert sum(1 for f in flags if f & 0x800) == 1

    # SA:Z on every primary part, each listing the OTHER part with its
    # soft-clip CIGAR (bwa mem_aln2sam)
    assert prims[0].sa and prims[1].sa
    f0 = prims[0].sa.rstrip(";").split(",")
    assert f0[0] == prims[1].ref_name
    assert int(f0[1]) == prims[1].ref_begin + 1
    assert f0[2] == ("-" if prims[1].is_reverse else "+")
    assert f0[3] == prims[1].cigar and "H" not in f0[3]
    assert int(f0[4]) == prims[1].mapq and int(f0[5]) == prims[1].nm
    assert prims[1].sa.split(",")[3] == prims[0].cigar

    # the supplementary record hard-clips: H in CIGAR, SEQ trimmed to
    # the aligned span; the primary record keeps soft clips + full SEQ
    lines = [l.split("\t") for l in sam.strip().split("\n")]
    supp = next(l for l in lines if int(l[1]) & 0x800)
    prim = next(l for l in lines if not int(l[1]) & 0x900)
    assert "H" in supp[5] and "S" not in supp[5]
    assert len(supp[9]) < len(read) and len(supp[9]) >= 50
    assert "H" not in prim[5] and len(prim[9]) == len(read)
    assert any(t.startswith("SA:Z:") for t in supp[11:])
    assert any(t.startswith("SA:Z:") for t in prim[11:])
    # tag order: SA after RG-position, before XA (bwa mem_aln2sam)
    tags = [t.split(":")[0] for t in prim[11:]]
    assert tags.index("SA") > tags.index("AS")


def test_long_reads_300bp(setup):
    # extension buffers adapt to batch width; 300bp reads (beyond the
    # old fixed 160-col buffers) must still equal the oracle
    g, idx = setup
    sim = simulate_reads(g, 8, read_len=300, sub_rate=0.02, seed=77)
    # add a 300bp read with a deletion
    reads = list(sim.reads) + [g[3000:3150] + g[3155:3305]]
    compare(setup, reads)


def test_alt_contig_handling(setup):
    # a duplicated contig marked ALT: the primary hit must land on the
    # non-ALT reference, with the ALT hit demoted to secondary
    g, _ = setup
    chrom = g[:8000]
    alt_piece = chrom[2000:3500]  # an "ALT haplotype" duplicate
    idx = build_index(
        [(1, "chr1", chrom), (2, "chr1_alt", alt_piece)],
        alt_names={"chr1_alt"},
    )
    assert list(idx.ref_is_alt) == [False, True]
    from bioseqdb_tpu.align.pipeline import align as align_fn

    read = chrom[2500:2620]  # maps equally to chr1 and chr1_alt
    res = align_fn([read], idx)[0]
    assert res.mapped
    prim = res.primary
    assert prim.ref_name == "chr1"           # ALT never shadows primary
    assert prim.ref_begin == 2500
    alt_hits = [h for h in res.hits if h.ref_name == "chr1_alt"]
    assert all(h.is_secondary for h in alt_hits)
    # save/load round-trips the flags
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        idx.save(d)
        from bioseqdb_tpu.index.fmindex import FMIndex
        assert list(FMIndex.load(d).ref_is_alt) == [False, True]


def test_overflow_fallback_on_repetitive_tract(setup):
    # reads inside a long homopolymer blow past the device seed caps;
    # the overflow flag must route them to the host oracle and still
    # produce oracle-equal records
    g0, _ = setup
    g = g0[:3000] + "A" * 800 + g0[3000:6000]
    idx = build_index([("r", g)])
    al = Aligner.build(idx, AlignOptions(), mode="full")
    reads = ["A" * 120, g[2950:3070], g[500:620]]
    batch = pack_reads(reads, ["polyA", "edge", "clean"])
    import jax

    out = jax.device_get(al.device_regions(batch))
    assert out["overflow"][0] and not out["overflow"][2]
    res = al.align_batch(batch)
    for i, r in enumerate(reads):
        want = O.align_read(idx, AlignOptions(), enc(r), rand_id=i)
        got = [(h.ref_begin, h.cigar, h.score, h.mapq) for h in res[i].hits]
        exp = [(a.pos, cigar_to_string(a.cigar), a.score, a.mapq) for a in want]
        assert got == exp, (i, got, exp)


def test_full_pipeline_int64_ranks(setup):
    """The whole device pipeline with int64 rank arrays (the >2^31-index
    configuration, under jax x64) must equal the int32 pipeline."""
    import jax
    from jax import enable_x64
    import jax.numpy as jnp
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.align.pipeline import full_align_step
    from bioseqdb_tpu.kernels import fm as kfm

    g, idx = setup
    opt = AlignOptions()
    sim = simulate_reads(g, 12, read_len=120, sub_rate=0.03, seed=88)
    batch = pack_reads(sim.reads, sim.names)
    mat = np.asarray(fill_scmat(1, 4), np.int32)
    kw = dict(
        min_seed_len=19, split_len=29, split_width=10, max_mem_intv=20,
        max_occ=500, max_seeds=64, max_chains=16,
        match_score=1, mismatch_penalty=4, o_del=6, e_del=1, o_ins=6,
        e_ins=1, bandwidth=100, zdrop=100, pen_clip5=5, pen_clip3=5,
        min_chain_weight=0, max_chain_gap=10000,
        mask_level=0.5, chain_drop_ratio=0.5,
    )
    fm32 = kfm.FMDevice.from_host(idx)
    import jax as _j
    pac32 = jnp.asarray(np.asarray(idx.pac), jnp.int8)
    out32 = _j.device_get(full_align_step(
        fm32, pac32, jnp.asarray(batch.codes, jnp.int32),
        jnp.asarray(batch.lens, jnp.int32), jnp.asarray(mat), **kw))
    with enable_x64():
        fm64 = kfm.FMDevice.from_host(idx, rank_dtype=jnp.int64)
        out64 = _j.device_get(full_align_step(
            fm64, pac32, jnp.asarray(batch.codes, jnp.int32),
            jnp.asarray(batch.lens, jnp.int32), jnp.asarray(mat), **kw))
    assert not out64["overflow"].any()
    for f in ("rb", "re", "qb", "qe", "score", "truesc", "seedcov"):
        assert np.array_equal(out64["regs"][f], out32["regs"][f]), f
    assert np.array_equal(out64["n_regs"], out32["n_regs"])
    assert out64["regs"]["rb"].dtype == np.int64


def test_absorb_overflow_device_retry(setup):
    # overflow rows re-run on device with fat caps (absorb_overflow)
    # must end up byte-equal to the normal path's records, with the
    # oracle fallback only for rows that STILL overflow (round 4: the
    # host oracle costs ~100 ms/read at chr20 scale)
    g, idx = setup
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bioseqdb_tpu.align.finalize import finalize_batch, maybe_unpack
    from bioseqdb_tpu.align.pipeline import _full_align_step_jit
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.io.batch import pack_reads

    al = Aligner.build(idx, AlignOptions(), mode="full")
    sim = simulate_reads(g, 24, read_len=150, sub_rate=0.01, seed=42)
    batch = pack_reads(sim.reads, sim.names)

    # starved caps: most reads overflow at the seeding stage
    mat = jnp.asarray(fill_scmat(
        al.options.match_score, al.options.mismatch_penalty
    ).astype(np.int32))
    common, _ = al._step_kwargs(150 if batch.codes.shape[1] <= 200
                                else batch.codes.shape[1])
    common.update(max_cand=3, max_mem=4)
    out_small = jax.device_get(_full_align_step_jit(
        al.fm, al.pac_dev, jnp.asarray(batch.codes, jnp.uint8),
        jnp.asarray(batch.lens, jnp.int32), mat, **common))
    n_ovf = int(np.asarray(out_small["overflow"]).sum())
    assert n_ovf > 0, "starved caps should overflow some reads"

    absorbed = al.absorb_overflow(batch, out_small)
    assert int(np.asarray(absorbed["overflow"]).sum()) < n_ovf

    want = finalize_batch(idx, al.options, batch,
                          jax.device_get(al.device_regions(batch)))
    got = finalize_batch(idx, al.options, batch, absorbed)
    for w, h in zip(want, got):
        assert [(x.ref_name, x.ref_begin, x.cigar, x.score, x.mapq, x.nm,
                 x.is_secondary) for x in w.hits] == \
               [(x.ref_name, x.ref_begin, x.cigar, x.score, x.mapq, x.nm,
                 x.is_secondary) for x in h.hits]


def test_supplementary_mapq_capped_at_primary(setup):
    # bwa mem_reg2sam: a non-ALT supplementary record's MAPQ caps at
    # the first primary's. Build a split read whose higher-score part
    # sits in the duplicated repeat (primary, MAPQ 0) while the other
    # part is unique (would be MAPQ 60 uncapped).
    g, idx = setup
    from bioseqdb_tpu.align.pipeline import align as align_fn

    read = g[8000:8090] + g[20000:20070]  # 90bp in repeat + 70bp unique
    res = align_fn([read], idx)[0]
    prims = [h for h in res.hits if not h.is_secondary]
    assert len(prims) == 2
    assert prims[0].query_match_len > prims[1].query_match_len
    assert prims[0].mapq <= 3          # repeat part: ambiguous
    assert prims[1].is_supplementary
    assert prims[1].mapq <= prims[0].mapq  # capped
    # and the SA tag carries the capped value
    assert f",{prims[1].mapq}," in prims[0].sa
