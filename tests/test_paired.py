"""Paired-end alignment tests: pestat, pairing, PE SAM."""

import numpy as np
import pytest

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.align.paired import PeStat, infer_dir, pestat
from bioseqdb_tpu.align.pipeline import Aligner
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.sam.emit import emit_sam_pairs
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_pairs


@pytest.fixture(scope="module")
def setup():
    g = simulate_genome(60_000, seed=71)
    idx = build_index([("ref", g)])
    r1, r2, inserts = simulate_pairs(
        g, 48, read_len=100, insert_mean=350, insert_std=30, sub_rate=0.01,
        seed=72,
    )
    return g, idx, r1, r2, inserts


def test_infer_dir_fr():
    # forward read at 100, reverse-strand mate: FR orientation, dist = insert
    l_pac = 10_000
    b1 = 100
    b2 = (2 * l_pac) - (100 + 400)  # mate's doubled coord (reverse strand)
    d, dist = infer_dir(l_pac, b1, b2)
    assert dist == 399
    d2, dist2 = infer_dir(l_pac, b2, b1)
    assert dist2 == 399


def test_pair_alignment_end_to_end(setup):
    g, idx, r1, r2, inserts = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(r2.reads, r2.names)
    pairs = al.align_pairs(b1, b2)
    assert len(pairs) == 48
    proper = 0
    for i, (res1, res2) in enumerate(pairs):
        assert res1.mapped and res2.mapped
        h1, h2 = res1.primary, res2.primary
        assert h1.ref_begin == r1.positions[i]
        assert h2.ref_begin == r2.positions[i]
        assert not h1.is_reverse and h2.is_reverse
        if res1.pe.flag_extra & 0x2:
            proper += 1
            # TLEN symmetric with opposite signs
            assert res1.pe.tlen == -res2.pe.tlen
            assert abs(res1.pe.tlen) == inserts[i]
    assert proper >= 40  # most pairs flagged proper


def test_pe_flags_and_sam(setup):
    # pairing statistics need >= MIN_DIR_CNT pairs in the batch, so run
    # the full batch and inspect the first 8 templates
    g, idx, r1, r2, _ = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(r2.reads, r2.names)
    pairs = al.align_pairs(b1, b2)[:8]
    sam = emit_sam_pairs(pairs, idx, r1.reads[:8], r2.reads[:8])
    body = [l for l in sam.strip().split("\n") if not l.startswith("@")]
    assert len(body) == 16
    for j, line in enumerate(body):
        f = line.split("\t")
        flag = int(f[1])
        assert flag & 0x1  # paired
        if j % 2 == 0:
            assert flag & 0x40 and not flag & 0x80
        else:
            assert flag & 0x80 and not flag & 0x40
        assert f[6] == "="  # same-reference mate
        assert int(f[8]) != 0  # TLEN set
    # mate coordinates cross-reference each other (1-based)
    a, b = body[0].split("\t"), body[1].split("\t")
    assert int(a[7]) == int(b[3]) and int(b[7]) == int(a[3])


def test_pestat_statistics(setup):
    g, idx, r1, r2, inserts = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    # build regs via the pairing entry (pestat is exercised inside), but
    # also test the function directly with synthetic regions
    from bioseqdb_tpu.cpu.oracle import AlnReg

    l_pac = idx.l_pac
    pairs = []
    rng = np.random.default_rng(0)
    for _ in range(40):
        ins = int(rng.normal(300, 20))
        p = int(rng.integers(0, l_pac - 600))
        r1_ = AlnReg(rb=p, re=p + 100, qb=0, qe=100, score=100)
        mate_fwd_end = p + ins
        rb2 = 2 * l_pac - mate_fwd_end
        r2_ = AlnReg(rb=rb2, re=rb2 + 100, qb=0, qe=100, score=100)
        pairs.append(([r1_], [r2_]))
    pes = pestat(pairs, AlignOptions(), l_pac)
    ok = [p for p in pes if not p.failed]
    assert len(ok) == 1
    st = ok[0]
    assert 260 <= st.avg <= 340
    assert st.low < 300 < st.high


def test_unmapped_mate(setup):
    g, idx, r1, r2, _ = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    junk = "N" * 100
    b1 = pack_reads([r1.reads[0]], ["p"])
    b2 = pack_reads([junk], ["p"])
    (res1, res2), = al.align_pairs(b1, b2)
    assert res1.mapped and not res2.mapped
    assert res1.pe.flag_extra & 0x8   # mate unmapped
    sam = emit_sam_pairs([(res1, res2)], idx, [r1.reads[0]], [junk], header=False)
    l1, l2 = sam.strip().split("\n")
    assert int(l2.split("\t")[1]) & 0x4


def test_cli_paired(tmp_path, setup):
    g, idx, r1, r2, _ = setup
    from bioseqdb_tpu.cli import main
    from bioseqdb_tpu.io.fasta import FastaRecord, write_fastq

    idx.save(str(tmp_path / "idx"))
    write_fastq(tmp_path / "r1.fq",
                [FastaRecord(n, n, s, "I" * len(s)) for n, s in
                 zip(r1.names[:6], r1.reads[:6])])
    write_fastq(tmp_path / "r2.fq",
                [FastaRecord(n, n, s, "I" * len(s)) for n, s in
                 zip(r2.names[:6], r2.reads[:6])])
    rc = main([
        "align", str(tmp_path / "idx"), str(tmp_path / "r1.fq"),
        "--mate", str(tmp_path / "r2.fq"),
        "-o", str(tmp_path / "out.sam"), "--cpu",
    ])
    assert rc == 0
    body = [l for l in (tmp_path / "out.sam").read_text().splitlines()
            if not l.startswith("@")]
    assert len(body) == 12
    assert all(int(l.split("\t")[1]) & 0x1 for l in body)


def test_native_local_sw_basics():
    import numpy as np
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.index.native.build import ksw_local_native

    mat = fill_scmat(1, 4)
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = t[100:180].copy()  # exact 80bp match inside the target
    score, qb, qe, tb, te, s2 = ksw_local_native(q, t, mat, 6, 1, 6, 1)
    assert score == 80 and (qb, qe) == (0, 80) and (tb, te) == (100, 180)
    # with two mismatches
    q2 = q.copy(); q2[10] = (q2[10] + 1) % 4; q2[50] = (q2[50] + 2) % 4
    score, qb, qe, tb, te, s2 = ksw_local_native(q2, t, mat, 6, 1, 6, 1)
    assert score == 80 - 10 and tb == 100


def test_mate_rescue_recovers_unseedable_mate():
    import numpy as np
    from bioseqdb_tpu.utils.sim import simulate_genome, simulate_pairs
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.io.batch import pack_reads

    g = simulate_genome(60_000, seed=91)
    idx = build_index([("ref", g)])
    r1, r2, inserts = simulate_pairs(g, 24, read_len=100, insert_mean=300,
                                     insert_std=20, seed=92)
    # corrupt one mate so heavily it cannot seed (every 12th base mutated
    # breaks all >=19bp seeds) but local SW can still place it
    bad = list(r2.reads[5])
    for k in range(0, 100, 12):
        bad[k] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bad[k]]
    reads2 = list(r2.reads)
    reads2[5] = "".join(bad)

    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(reads2, r2.names)
    pairs = al.align_pairs(b1, b2)
    res1, res2 = pairs[5]
    assert res1.mapped and res2.mapped
    # the rescued mate lands at its true position on the reverse strand
    # (up to soft-clipping of corrupted end bases by the local SW)
    assert abs(res2.primary.ref_begin - r2.positions[5]) <= 6
    assert res2.primary.is_reverse
    assert res2.primary.cigar.count("M") == 1
    assert res2.pe.flag_extra & 0x2  # proper pair after rescue


@pytest.mark.parametrize("case", range(int(__import__("os").environ.get("PE_FUZZ_CASES", "3"))))
def test_pe_invariants_fuzz(case):
    """Randomized paired-end runs checked against SAM pairing invariants:
    flag consistency, TLEN antisymmetry, mate cross-references, proper-
    pair implications, and truth positions for clean pairs."""
    rng = np.random.default_rng(4321 + case)
    g = simulate_genome(32_000, seed=int(rng.integers(1 << 30)))
    idx = build_index([("ref", g)])
    mean = float(rng.integers(250, 450))
    sub_rate = float(rng.choice([0.0, 0.02]))
    r1, r2, inserts = simulate_pairs(
        g, 24, read_len=int(rng.choice([96, 144])), insert_mean=mean,
        insert_std=float(rng.integers(15, 40)),
        sub_rate=sub_rate,
        seed=int(rng.integers(1 << 30)),
    )
    al = Aligner.build(idx, AlignOptions(), mode="full")
    pairs = al.align_pairs(pack_reads(r1.reads, r1.names),
                           pack_reads(r2.reads, r2.names))
    n_proper = 0
    for i, (res1, res2) in enumerate(pairs):
        pe1, pe2 = res1.pe, res2.pe
        assert pe1.flag_extra & 0x1 and pe2.flag_extra & 0x1
        assert pe1.flag_extra & 0x40 and pe2.flag_extra & 0x80
        # mate-reverse bits mirror the mate's strand
        if res1.mapped and res2.mapped:
            assert bool(pe1.flag_extra & 0x20) == res2.primary.is_reverse
            assert bool(pe2.flag_extra & 0x20) == res1.primary.is_reverse
            p1 = (pe1.flag_extra & 0x2) != 0
            p2 = (pe2.flag_extra & 0x2) != 0
            assert p1 == p2  # proper flag symmetric
            if p1:
                n_proper += 1
                assert pe1.tlen == -pe2.tlen and pe1.tlen != 0
                assert pe1.rnext == "=" and pe2.rnext == "="
                assert pe1.pnext == res2.primary.ref_begin
                assert pe2.pnext == res1.primary.ref_begin
            # simulated pairs land at truth, within soft-clip shifts:
            # mutated reads clip end-proximal substitution clusters, and
            # insert-size outliers can be mate-rescued inside the expected
            # window with the window boundary clipping a few bases (bwa
            # behaves the same) — POS then shifts by the clip length
            assert abs(res1.primary.ref_begin - r1.positions[i]) <= 20
            assert abs(res2.primary.ref_begin - r2.positions[i]) <= 20
        if not res2.mapped:
            assert pe1.flag_extra & 0x8
    assert n_proper >= 20  # stats converge for same-distribution batches


def test_pe_fast_path_matches_slow(setup):
    """The vectorized PE fast path must produce identical records to the
    per-read path (forced by disabling fast eligibility)."""
    import numpy as np

    import bioseqdb_tpu.align.finalize as F
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.paired import finalize_pairs
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_pairs

    g, idx = setup[0], setup[1]
    opt = AlignOptions()
    sr1, sr2, _ = simulate_pairs(g, 96, read_len=100, sub_rate=0.01,
                                 insert_mean=300, insert_std=30, seed=55)
    b1 = pack_reads(sr1.reads, sr1.names)
    b2 = pack_reads(sr2.reads, sr2.names)
    al = Aligner.build(idx, opt, mode="full")
    import jax

    out1 = jax.device_get(al.device_regions(b1))
    out2 = jax.device_get(al.device_regions(b2))

    fast = finalize_pairs(idx, opt, b1, out1, b2, out2)

    real_ff = F.fast_fields

    def no_fast(*a, **kw):
        f = real_ff(*a, **kw)
        f["fast"] = np.zeros_like(f["fast"])
        return f

    F.fast_fields, saved = no_fast, real_ff
    try:
        slow = finalize_pairs(idx, opt, b1, out1, b2, out2)
    finally:
        F.fast_fields = saved

    n_fastpairs = 0
    for (fa, fb), (sa, sb) in zip(fast, slow):
        for x, y in zip((fa, fb), (sa, sb)):
            assert len(x.hits) == len(y.hits)
            for hx, hy in zip(x.hits, y.hits):
                assert hx == hy, (x.query_name, hx, hy)
            assert x.pe == y.pe, (x.query_name, x.pe, y.pe)
        n_fastpairs += 1
    assert n_fastpairs == 96


def test_columns_pe_equal(setup):
    """Columnar PE finalize + emitter == per-pair finalize + emitter,
    byte-for-byte SAM (incl. flags, TLEN, MAPQ uplift, tags)."""
    import jax

    from bioseqdb_tpu.align.paired import finalize_pairs, finalize_pairs_columns
    from bioseqdb_tpu.sam.emit import emit_sam_pair_columns

    g, idx, r1, r2, inserts = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(r2.reads, r2.names)
    out1 = jax.device_get(al.device_regions(b1))
    out2 = jax.device_get(al.device_regions(b2))
    pairs = finalize_pairs(idx, al.options, b1, out1, b2, out2)
    want = emit_sam_pairs(pairs, idx, list(r1.reads), list(r2.reads))
    cols1, cols2 = finalize_pairs_columns(idx, al.options, b1, out1, b2, out2)
    got = emit_sam_pair_columns(cols1, cols2, idx, b1, b2,
                                seqs1=list(r1.reads), seqs2=list(r2.reads))
    assert cols1.fast.any()  # the vector path actually ran
    if got != want:
        import difflib
        diff = "\n".join(difflib.unified_diff(
            want.splitlines(), got.splitlines(), lineterm="", n=1))
        raise AssertionError(diff[:4000])


def test_fused_pair_dispatch_equals_separate(setup):
    # the fused one-dispatch PE step (device_regions_pair) must return
    # exactly the two dicts the separate per-mate dispatches produce
    import jax

    g, idx, r1, r2, inserts = setup
    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(r2.reads, r2.names)
    f1, f2 = al.device_regions_pair(b1, b2)
    s1 = al.device_regions(b1)
    s2 = al.device_regions(b2)
    for fused, sep in ((f1, s1), (f2, s2)):
        fused, sep = jax.device_get(fused), jax.device_get(sep)
        assert set(fused) == set(sep)
        for k in sep:
            if isinstance(sep[k], dict):
                for kk in sep[k]:
                    assert (np.asarray(fused[k][kk])
                            == np.asarray(sep[k][kk])).all(), (k, kk)
            else:
                assert (np.asarray(fused[k]) == np.asarray(sep[k])).all(), k


def test_pe_chimeric_supplementary(setup):
    # a split R1 (two halves from far-apart loci) in a pair: the PE
    # path must emit the other primary part as a supplementary record
    # with 0x800 | PE flags, hard clips, and SA:Z on both parts
    # (bwa mem_sam_pe behavior)
    g, idx, r1, r2, inserts = setup
    from bioseqdb_tpu.sam.emit import revcomp

    al = Aligner.build(idx, AlignOptions(), mode="full")
    n = 16
    reads1 = list(r1.reads[:n])
    reads2 = list(r2.reads[:n])
    reads1[3] = g[5000:5075] + g[40000:40075]   # split read
    b1 = pack_reads(reads1, [f"p{i}" for i in range(n)])
    b2 = pack_reads(reads2, [f"p{i}" for i in range(n)])
    pairs = al.align_pairs(b1, b2)
    res1, res2 = pairs[3]
    prims = [h for h in res1.hits if not h.is_secondary]
    assert len(prims) == 2
    assert prims[1].is_supplementary and not prims[0].is_supplementary
    assert prims[0].sa and prims[1].sa
    assert prims[1].pe is not None  # its own PEInfo for emission

    sam = emit_sam_pairs(pairs, idx, reads1, reads2, header=False)
    lines = [l.split("\t") for l in sam.strip().split("\n")
             if l.split("\t")[0] == "p3"]
    assert len(lines) == 3  # R1 primary + R1 supplementary + R2
    supp = next(l for l in lines if int(l[1]) & 0x800)
    flag = int(supp[1])
    assert flag & 0x1 and flag & 0x40       # paired, first-in-pair
    assert "H" in supp[5] and "S" not in supp[5]
    assert len(supp[9]) < len(reads1[3])
    assert any(t.startswith("SA:Z:") for t in supp[11:])
    prim = next(l for l in lines if int(l[1]) & 0x40 and not int(l[1]) & 0x800)
    assert any(t.startswith("SA:Z:") for t in prim[11:])
    assert len(prim[9]) == len(reads1[3])


def test_absorb_overflow_pair_equals_single(setup):
    # one fused fat retry for both mates == two per-mate retries
    g, idx, r1, r2, inserts = setup
    import jax
    import jax.numpy as jnp
    from bioseqdb_tpu.align.pipeline import _full_align_step_jit
    from bioseqdb_tpu.cpu.ksw import fill_scmat

    al = Aligner.build(idx, AlignOptions(), mode="full")
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(r2.reads, r2.names)
    mat = jnp.asarray(fill_scmat(
        al.options.match_score, al.options.mismatch_penalty
    ).astype(np.int32))

    def starved(b):
        common, _ = al._step_kwargs(int(b.codes.shape[1]))
        common.update(max_cand=3, max_mem=4)
        return jax.device_get(_full_align_step_jit(
            al.fm, al.pac_dev, jnp.asarray(b.codes, jnp.uint8),
            jnp.asarray(b.lens, jnp.int32), mat, **common))

    s1, s2 = starved(b1), starved(b2)
    assert np.asarray(s1["overflow"]).sum() > 0
    a1 = al.absorb_overflow(b1, dict(s1))
    a2 = al.absorb_overflow(b2, dict(s2))
    p1, p2 = al.absorb_overflow_pair(b1, dict(s1), b2, dict(s2))
    for want, got in ((a1, p1), (a2, p2)):
        assert (np.asarray(want["overflow"])
                == np.asarray(got["overflow"])).all()
        assert (np.asarray(want["n_regs"]) == np.asarray(got["n_regs"])).all()
        for k in want["regs"]:
            assert (np.asarray(want["regs"][k])
                    == np.asarray(got["regs"][k])).all(), k
