"""BWT-interval-sharded index: sharded rank ops equal the unsharded path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bioseqdb_tpu.dist.shard_index import (
    FMSharded,
    backward_search_sharded,
    sa_resolve_sharded,
    shard_index,
)
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.kernels import fm as kfm
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads


@pytest.fixture(scope="module")
def setup():
    g = simulate_genome(30_000, seed=81)
    idx = build_index([("ref", g)])
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("index",))
    fm = kfm.FMDevice.from_host(idx)
    fms = shard_index(idx, mesh)
    return g, idx, mesh, fm, fms


def test_sharding_layout(setup):
    g, idx, mesh, fm, fms = setup
    assert fms.blocks.shape[0] == 4
    # octo device layout: 8 Occ blocks per 96-int32 row (kernels/fm.py)
    assert fms.blocks.shape[2] == 128
    assert (fms.blocks.shape[0] * fms.blocks.shape[1] * 8
            >= idx.blocks.shape[0])
    # each device holds exactly one row-range shard of the table
    assert len(fms.blocks.sharding.device_set) == 4
    # the replicated arrays are everywhere
    assert len(fms.sa_sample.sharding.device_set) == 4


def test_backward_search_sharded_agrees(setup):
    g, idx, mesh, fm, fms = setup
    sim = simulate_reads(g, 32, read_len=90, sub_rate=0.02, seed=2)
    batch = pack_reads(sim.reads, sim.names)
    codes = jnp.asarray(batch.codes, jnp.int32)
    lens = jnp.asarray(batch.lens, jnp.int32)
    lo_u, hi_u = kfm.backward_search(fm, codes, lens)
    lo_s, hi_s = backward_search_sharded(fms, codes, lens, mesh)
    assert np.array_equal(np.asarray(lo_u), np.asarray(lo_s))
    assert np.array_equal(np.asarray(hi_u), np.asarray(hi_s))


def test_sa_resolve_sharded_agrees(setup):
    g, idx, mesh, fm, fms = setup
    rng = np.random.default_rng(3)
    ranks = jnp.asarray(rng.integers(1, idx.seq_len + 1, 512), jnp.int32)
    got = np.asarray(sa_resolve_sharded(fms, ranks, mesh))
    want = np.asarray(kfm.sa_resolve(fm, ranks))
    assert np.array_equal(got, want)


def test_sharded_end_to_end_positions(setup):
    g, idx, mesh, fm, fms = setup
    sim = simulate_reads(g, 16, read_len=80, seed=4)
    batch = pack_reads(sim.reads, sim.names)
    codes = jnp.asarray(batch.codes, jnp.int32)
    lens = jnp.asarray(batch.lens, jnp.int32)
    lo, hi = backward_search_sharded(fms, codes, lens, mesh)
    pos = np.asarray(sa_resolve_sharded(fms, lo, mesh))
    for i in range(16):
        assert hi[i] - lo[i] >= 1
        fwd, rev = idx.depos(int(pos[i]), 80)
        assert fwd == sim.positions[i] and rev == bool(sim.strands[i])


def test_uneven_shard_count(setup):
    # 3 shards: row padding exercised
    g, idx, _, fm, _ = setup
    mesh3 = Mesh(np.array(jax.devices()[:3]), axis_names=("index",))
    fms3 = shard_index(idx, mesh3)
    rng = np.random.default_rng(5)
    ranks = jnp.asarray(rng.integers(1, idx.seq_len + 1, 128), jnp.int32)
    got = np.asarray(sa_resolve_sharded(fms3, ranks, mesh3))
    want = np.asarray(kfm.sa_resolve(fm, ranks))
    assert np.array_equal(got, want)


def test_full_pipeline_sharded_2d_mesh(setup):
    """The whole device pipeline over a (data x index) mesh equals the
    single-device pipeline, end to end through host finalize."""
    import jax.numpy as jnp2
    from jax.sharding import Mesh as Mesh2
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.finalize import finalize_batch
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.dist.shard_index import full_align_step_sharded, shard_index
    from bioseqdb_tpu.io.batch import pack_reads

    g, idx, _, fm, _ = setup
    opt = AlignOptions()
    sim = simulate_reads(g, 16, read_len=120, sub_rate=0.03, seed=9)
    batch = pack_reads(sim.reads, sim.names, pad_reads_to=4)

    mesh2 = Mesh2(np.array(jax.devices()[:8]).reshape(2, 4),
                  axis_names=("data", "index"))
    fms = shard_index(idx, mesh2)
    mat = jnp2.asarray(fill_scmat(1, 4).astype(np.int32))
    out_sh = jax.device_get(full_align_step_sharded(
        fms, jnp2.asarray(batch.codes, jnp2.int32),
        jnp2.asarray(batch.lens, jnp2.int32), mat, mesh2, opt, idx.n_refs,
        data_axis="data",
    ))
    assert not out_sh["overflow"].any()

    al = Aligner.build(idx, opt, mode="full")
    from bioseqdb_tpu.align.finalize import maybe_unpack
    out_un = maybe_unpack(jax.device_get(al.device_regions(batch)))
    for f in ("rb", "re", "qb", "qe", "score", "truesc", "seedcov"):
        assert np.array_equal(out_sh["regs"][f], out_un["regs"][f]), f
    assert np.array_equal(out_sh["n_regs"], out_un["n_regs"])

    # and identical final records through the host finalizer
    res_sh = finalize_batch(idx, opt, batch, out_sh)
    res_un = finalize_batch(idx, opt, batch, out_un)
    for a, b in zip(res_sh, res_un):
        ka = [(h.ref_begin, h.cigar, h.score, h.mapq) for h in a.hits]
        kb = [(h.ref_begin, h.cigar, h.score, h.mapq) for h in b.hits]
        assert ka == kb


def test_aligner_2d_mesh(setup):
    """Aligner.build with a (data, index) mesh runs the sharded pipeline
    end-to-end and matches the unsharded Aligner exactly."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.io.batch import pack_reads
    from bioseqdb_tpu.utils.sim import simulate_reads

    g, idx, _, fm, _ = setup
    opt = AlignOptions()
    sim = simulate_reads(g, 15, read_len=110, sub_rate=0.03, seed=31)
    batch = pack_reads(sim.reads, sim.names, pad_reads_to=4)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                axis_names=("data", "index"))
    al2 = Aligner.build(idx, opt, mesh=mesh)
    al1 = Aligner.build(idx, opt, mode="full")
    res2 = al2.align_batch(batch)
    res1 = al1.align_batch(batch)
    assert len(res2) >= len(res1)  # data-axis padding rows may be appended
    for a, b in zip(res1, res2[: len(res1)]):
        ka = [(h.ref_begin, h.cigar, h.score, h.mapq, h.is_reverse)
              for h in a.hits]
        kb = [(h.ref_begin, h.cigar, h.score, h.mapq, h.is_reverse)
              for h in b.hits]
        assert ka == kb


def test_sharded_int64_ranks_agree(setup):
    """Forced-int64 rank arithmetic through the sharded path (the
    GRCh38-class configuration: >2^31 conceptual ranks, int32 tables,
    int64 rank values). Every sharded query must
    equal the int32 unsharded reference on the same (small) index."""
    g, idx, mesh, fm, _ = setup
    sim = simulate_reads(g, 24, read_len=90, sub_rate=0.02, seed=17)
    batch = pack_reads(sim.reads, sim.names)
    codes = jnp.asarray(batch.codes, jnp.int32)
    lens = jnp.asarray(batch.lens, jnp.int32)
    lo_u, hi_u = kfm.backward_search(fm, codes, lens)
    rng = np.random.default_rng(7)
    ranks32 = rng.integers(1, idx.seq_len + 1, 256)
    pos_u = kfm.sa_resolve(fm, jnp.asarray(ranks32, jnp.int32),
                           idx.sa_interval)
    with jax.enable_x64():
        fms64 = shard_index(idx, mesh, rank_dtype=jnp.int64)
        assert fms64.sa_sample.dtype == jnp.int64
        assert fms64.blocks.dtype == jnp.int32  # tables stay int32
        lo_s, hi_s = backward_search_sharded(fms64, codes, lens, mesh)
        assert np.array_equal(np.asarray(lo_u), np.asarray(lo_s))
        assert np.array_equal(np.asarray(hi_u), np.asarray(hi_s))
        pos_s = sa_resolve_sharded(
            fms64, jnp.asarray(ranks32, jnp.int64), mesh,
            sa_interval=idx.sa_interval)
        assert np.array_equal(np.asarray(pos_u), np.asarray(pos_s))


def test_sharded_int64_full_pipeline(setup):
    """Forced-int64 full sharded pipeline == int32 unsharded regions."""
    from bioseqdb_tpu.align.options import AlignOptions
    from bioseqdb_tpu.align.finalize import maybe_unpack
    from bioseqdb_tpu.align.pipeline import Aligner
    from bioseqdb_tpu.cpu.ksw import fill_scmat
    from bioseqdb_tpu.dist.shard_index import full_align_step_sharded

    g, idx, _, fm, _ = setup
    opt = AlignOptions()
    sim = simulate_reads(g, 12, read_len=120, sub_rate=0.03, seed=19)
    batch = pack_reads(sim.reads, sim.names, pad_reads_to=4)
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 axis_names=("data", "index"))
    al = Aligner.build(idx, opt, mode="full")
    out_un = maybe_unpack(jax.device_get(al.device_regions(batch)))
    with jax.enable_x64():
        fms64 = shard_index(idx, mesh2, rank_dtype=jnp.int64)
        mat = jnp.asarray(fill_scmat(1, 4).astype(np.int32))
        out_sh = jax.device_get(full_align_step_sharded(
            fms64, jnp.asarray(batch.codes, jnp.int32),
            jnp.asarray(batch.lens, jnp.int32), mat, mesh2, opt,
            idx.n_refs, data_axis="data",
        ))
    assert not out_sh["overflow"].any()
    for f in ("rb", "re", "qb", "qe", "score", "truesc", "seedcov"):
        assert np.array_equal(out_sh["regs"][f], out_un["regs"][f]), f
    assert np.array_equal(out_sh["n_regs"], out_un["n_regs"])


def test_sharded_resolve_nonzero_majors():
    """Sharded LF steps must fold the major-checkpoint term INSIDE the
    owner-masked psum: ``c`` is decoded from the sharded row (garbage on
    non-owner shards), so a post-psum major add mixes every shard's
    local-c major. Needs an index big enough for a NONZERO second major
    row (> MAJOR_BLOCKS * 128 / 2 forward bases) — all-zero-major small
    indexes masked the bug for two rounds (caught at 3.1 G doubled,
    tools/bigindex_sharded_check.py round 3)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bioseqdb_tpu.dist.shard_index import sa_resolve_sharded, shard_index
    from bioseqdb_tpu.index.builder import build_index
    from bioseqdb_tpu.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK
    from bioseqdb_tpu.utils.sim import simulate_genome

    n_fwd = (MAJOR_BLOCKS * OCC_BLOCK) // 2 + 500_000  # 2+ major rows
    g = simulate_genome(n_fwd, seed=77)
    idx = build_index([("maj", g)])
    assert idx.occ_majors.shape[0] >= 2 and idx.occ_majors[1:].any()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "index"))
    fms = shard_index(idx, mesh)
    rng = np.random.default_rng(9)
    ranks = rng.integers(0, idx.seq_len + 1, size=64)
    pos = np.asarray(jax.device_get(sa_resolve_sharded(
        fms, jnp.asarray(ranks, fms.sa_sample.dtype), mesh,
        sa_interval=idx.sa_interval)))
    for r, p in zip(ranks, pos):
        assert int(p) == idx.sa_at(int(r)), (r, p)
