"""End-to-end exact-match pipeline tests (BASELINE.md config 1 scope)."""

import numpy as np
import pytest

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.align.pipeline import Aligner, align
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.sam.emit import emit_sam, revcomp, sam_header
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads


@pytest.fixture(scope="module")
def lambda_setup():
    g = simulate_genome(48_000, seed=1)
    idx = build_index([("lambda", g)])
    sim = simulate_reads(g, 100, read_len=100, seed=2)
    return g, idx, sim


def test_exact_align_all_simulated_reads(lambda_setup):
    g, idx, sim = lambda_setup
    results = align(sim.reads, idx)
    assert len(results) == 100
    for res, p, s in zip(results, sim.positions, sim.strands):
        assert res.mapped
        prim = res.primary
        assert prim.is_primary and not prim.is_secondary
        assert prim.ref_begin == p
        assert prim.ref_end == p + 100
        assert prim.is_reverse == bool(s)
        assert prim.cigar == "100M"
        assert prim.ref_name == "lambda"
        assert prim.mapq == 60 or len(res.hits) > 1


def test_unmapped_read(lambda_setup):
    _, idx, _ = lambda_setup
    # a read alphabet-shifted so it (almost surely) doesn't occur
    results = align(["ACGT" * 25 + "GGGGGGGG" * 3], idx)
    # either unmapped or mapped — but N-read is deterministic:
    results = align(["ACGTN" + "A" * 50], idx)
    assert not results[0].mapped


def test_multi_hit_secondary_marking():
    # a genome with an exact repeat: the repeated read hits twice
    core = simulate_genome(3000, seed=3)
    repeat = simulate_genome(200, seed=4)
    g = core[:1000] + repeat + core[1000:2000] + repeat + core[2000:]
    idx = build_index([("rep", g)])
    read = repeat[50:130]
    res = align([read], idx, max_hits=8)[0]
    assert len(res.hits) >= 2
    assert res.hits[0].is_primary and not res.hits[0].is_secondary
    assert all(h.is_secondary for h in res.hits[1:])
    assert res.hits[0].mapq == 0  # ambiguous
    begins = sorted(h.ref_begin for h in res.hits[:2])
    assert begins == [1050, 2250]


def test_multi_ref_rebase_and_no_bridging():
    a = simulate_genome(500, seed=5)
    b = simulate_genome(500, seed=6)
    idx = build_index([(11, "chrA", a), (22, "chrB", b)])
    res = align([b[100:180]], idx)[0]
    assert res.primary.ref_name == "chrB"
    assert res.primary.ref_id == 22
    assert res.primary.ref_begin == 100
    # a read spanning the A|B junction must not produce any hit crossing
    # a reference boundary; the full pipeline splits it into two clipped
    # alignments (one per reference), like bwa mem on a chimeric read
    junction = (a + b)[460:540]
    res = align([junction], idx)[0]
    ref_lens = {"chrA": 500, "chrB": 500}
    for h in res.hits:
        assert 0 <= h.ref_begin and h.ref_end <= ref_lens[h.ref_name]
    names = {h.ref_name for h in res.hits}
    assert names == {"chrA", "chrB"}


def test_align_options_bind(lambda_setup):
    _, idx, sim = lambda_setup
    aligner = Aligner.build(idx, AlignOptions(max_occ=4))
    batch = pack_reads(sim.reads[:10], sim.names[:10])
    results = aligner.align_batch(batch)
    assert all(r.mapped for r in results)
    assert results[0].hits[0].query_name == "sim0"
    assert results[0].hits[0].query_id == 0


def test_sam_emission(lambda_setup):
    g, idx, sim = lambda_setup
    reads, names = sim.reads[:5], sim.names[:5]
    batch = pack_reads(reads, names)
    results = Aligner.build(idx).align_batch(batch)
    sam = emit_sam(results, idx, reads)
    lines = sam.strip().split("\n")
    assert lines[0].startswith("@HD\tVN:1.6")
    assert lines[1] == f"@SQ\tSN:lambda\tLN:48000"
    assert lines[2].startswith("@PG\tID:bioseqdb-tpu")
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) == 5
    for line, p, s, read in zip(body, sim.positions, sim.strands, reads):
        f = line.split("\t")
        assert f[0].startswith("sim")
        flag, pos, mapq, cigar = int(f[1]), int(f[3]), int(f[4]), f[5]
        assert pos == p + 1  # 1-based
        assert cigar == "100M"
        assert (flag & 0x10 != 0) == bool(s)
        # SEQ is reported on the forward reference strand
        assert f[9] == (revcomp(read) if s else read)
        assert f[9] == g[p : p + 100]


def test_sam_unmapped_record(lambda_setup):
    _, idx, _ = lambda_setup
    read = "ACGTN" + "A" * 40
    results = align([read], idx)
    sam = emit_sam(results, idx, [read], header=False)
    f = sam.strip().split("\t")
    assert int(f[1]) & 0x4
    assert f[2] == "*" and f[3] == "0" and f[5] == "*"
    assert f[9] == read


def test_sam_secondary_record_has_star_seq():
    core = simulate_genome(2000, seed=7)
    rep = simulate_genome(120, seed=8)
    g = core[:600] + rep + core[600:1200] + rep + core[1200:]
    idx = build_index([("r", g)])
    read = rep[10:90]
    results = align([read], idx, max_hits=4)
    sam = emit_sam(results, idx, [read], header=False)
    body = sam.strip().split("\n")
    assert len(body) >= 2
    sec = body[1].split("\t")
    assert int(sec[1]) & 0x100
    assert sec[9] == "*" and sec[10] == "*"


def test_cli_end_to_end(tmp_path):
    from bioseqdb_tpu.cli import main
    from bioseqdb_tpu.io.fasta import write_fasta, write_fastq, FastaRecord

    g = simulate_genome(5000, seed=9)
    sim = simulate_reads(g, 30, read_len=80, seed=10)
    write_fasta(tmp_path / "ref.fa", [("ref", g)])
    write_fastq(
        tmp_path / "reads.fq",
        [FastaRecord(n, n, r, "I" * 80) for n, r in zip(sim.names, sim.reads)],
    )
    assert main(["index", str(tmp_path / "ref.fa"), "-o", str(tmp_path / "idx")]) == 0
    assert (
        main([
            "align", str(tmp_path / "idx"), str(tmp_path / "reads.fq"),
            "-o", str(tmp_path / "out.sam"), "--cpu",
        ])
        == 0
    )
    sam = (tmp_path / "out.sam").read_text()
    body = [l for l in sam.strip().split("\n") if not l.startswith("@")]
    assert len(body) >= 30
    mapped = [l for l in body if not int(l.split("\t")[1]) & 0x4]
    assert len(mapped) == 30
    # import analogue
    assert main([
        "import", str(tmp_path / "reads.fq"), "-o", str(tmp_path / "shards"),
        "--batch-size", "16",
    ]) == 0
    import numpy as np
    import os

    shards = sorted(f for f in os.listdir(tmp_path / "shards")
                    if f.endswith(".npz"))
    assert len(shards) == 2
    assert (tmp_path / "shards" / "manifest.json").exists()  # resume manifest
    z = np.load(tmp_path / "shards" / shards[0])
    assert z["codes"].shape[0] >= 16


def test_exact_mode_field_complete(lambda_setup):
    # mode="exact" records carry the full bwa_result field set for what
    # they report: CIGAR/NM/MD/AS by construction, MAPQ/XS as the bwa
    # formula's exact outcome for full-length exact matches
    g, idx, sim = lambda_setup
    al = Aligner.build(idx, AlignOptions(), mode="exact")
    batch = pack_reads(list(sim.reads[:20]), [f"r{i}" for i in range(20)])
    results = al.align_batch(batch)
    for res, p in zip(results, sim.positions[:20]):
        assert res.mapped
        h = res.primary
        assert h.ref_begin == p
        assert h.cigar == "100M" and h.nm == 0 and h.md == "100"
        assert h.score == 100 and h.mapq == 60 and h.sub == 0
    sam = emit_sam(results, idx, [r for r in sim.reads[:20]], header=False)
    line = sam.splitlines()[0].split("\t")
    assert "NM:i:0" in line and "MD:Z:100" in line
    assert "AS:i:100" in line and "XS:i:0" in line

    # repeated read: primary XS = repeat score, MAPQ 0 (sub >= score),
    # secondary records keep XS unset like full mode
    core = simulate_genome(3000, seed=3)
    repeat = simulate_genome(200, seed=4)
    g2 = core[:1000] + repeat + core[1000:2000] + repeat + core[2000:]
    idx2 = build_index([("rep", g2)])
    al2 = Aligner.build(idx2, AlignOptions(), mode="exact")
    res = al2.align_batch(pack_reads([repeat[50:130]], ["rep"]))[0]
    assert len(res.hits) >= 2
    assert res.hits[0].mapq == 0 and res.hits[0].sub == 80
    assert res.hits[0].nm == 0 and res.hits[0].md == "80"
    assert res.hits[1].sub == -1 and res.hits[1].mapq == 0


def test_pack_codes_2bit_roundtrip():
    # wire packing: 2-bit codes + ambiguity bitmap must round-trip for
    # widths that are and aren't multiples of 8 (pads with code 4)
    import jax
    from bioseqdb_tpu.align.pipeline import pack_codes_2bit, _unpack_codes

    rng = np.random.default_rng(11)
    for B, W in ((3, 7), (5, 145), (4, 160)):
        codes = rng.integers(0, 5, (B, W)).astype(np.uint8)
        u2, nmb = pack_codes_2bit(codes)
        assert u2.shape[1] * 4 % 8 == 0
        got = np.asarray(jax.jit(_unpack_codes)(u2, nmb))
        Wp = u2.shape[1] * 4
        assert got.shape == (B, Wp)
        assert (got[:, :W] == codes).all()
        assert (got[:, W:] == 4).all()
