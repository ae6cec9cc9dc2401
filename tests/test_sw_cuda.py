"""The CUDA banded-SW kernel (kernels/sw_extend.cu) against the XLA
reference kernel (kernels/sw.py:sw_extend_batch).

The kernel itself runs only on a GPU: the ``gpu``-marked sweep below
skips elsewhere, and ``python3 chip_smoke.py`` runs the same sweep on
the card. What the CPU can check runs here: the kernel choice per
platform, the wrapper's operand layout and casts, and a line-for-line
Python model of the kernel's row loop, pinned to the XLA kernel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.kernels.extend import sw_kernel_for
from bioseqdb_tpu.kernels.sw import sw_extend_batch
from bioseqdb_tpu.kernels.sw_cuda import to_kernel_layout

GAPS = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)


def make_cases(seed, n, max_q, max_t, plant=0.6, codes=4, h0=(1, 60)):
    """Random (query, target, h0) triples; most targets carry a mutated
    copy of the query so that the DP runs long."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        ql = int(rng.integers(1, max_q + 1))
        tl = int(rng.integers(1, max_t + 1))
        qq = rng.integers(0, codes, ql)
        tt = rng.integers(0, codes, tl)
        if rng.random() < plant and tl >= ql:
            tt[:ql] = qq
            for _ in range(int(rng.integers(0, 4))):
                tt[int(rng.integers(0, ql))] = rng.integers(0, 4)
        cases.append((qq, tt, int(rng.integers(*h0))))
    return cases


def pack(cases, max_qlen, max_tlen):
    B = len(cases)
    q = np.full((B, max_qlen), 4, np.int32)
    t = np.full((B, max_tlen), 4, np.int32)
    qlen, tlen, h0 = (np.zeros(B, np.int32) for _ in range(3))
    for i, (qq, tt, hh) in enumerate(cases):
        q[i, : len(qq)] = qq
        t[i, : len(tt)] = tt
        qlen[i], tlen[i], h0[i] = len(qq), len(tt), hh
    return q, qlen, t, tlen, h0


def run_xla(q, qlen, t, tlen, w0, h0, match=1, mismatch=4, end_bonus=5,
            zdrop=100):
    out = sw_extend_batch(
        jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t), jnp.asarray(tlen),
        jnp.asarray(fill_scmat(match, mismatch)), GAPS["o_del"],
        GAPS["e_del"], GAPS["o_ins"], GAPS["e_ins"], jnp.asarray(w0),
        end_bonus, zdrop, jnp.asarray(h0), q.shape[1])
    return {k: np.asarray(v) for k, v in out.items()}


# (name, make_cases kwargs, max_qlen, max_tlen, band, end_bonus, zdrop):
# the DP sweeps of the XLA kernel's own tests, plus full-width lanes
# (qlen == max_qlen) and the pipeline's 150 bp extension shape
SWEEPS = [
    ("random", dict(seed=1, n=48, max_q=50, max_t=90), 64, 128, 100, 5, 100),
    ("narrow_band", dict(seed=2, n=24, max_q=40, max_t=60, plant=0),
     64, 128, 3, 5, 100),
    ("zdrop_tight", dict(seed=3, n=24, max_q=60, max_t=100), 64, 128, 100,
     5, 5),
    ("ambiguous", dict(seed=4, n=24, max_q=30, max_t=40, codes=5), 64, 128,
     100, 5, 100),
    ("full_width", dict(seed=5, n=32, max_q=32, max_t=80, h0=(20, 80)),
     32, 96, 100, 0, 100),
    ("read_150bp", dict(seed=6, n=64, max_q=150, max_t=400, plant=0.9,
                        h0=(19, 150)), 152, 614, 100, 5, 100),
]


def sweep_inputs(sweep):
    _, kw, max_q, max_t, band, bonus, zdrop = sweep
    q, qlen, t, tlen, h0 = pack(make_cases(**kw), max_q, max_t)
    w0 = np.full(len(qlen), band, np.int32)
    return (q, qlen, t, tlen, w0, h0), dict(end_bonus=bonus, zdrop=zdrop)


def compare_cuda_to_xla(args, end_bonus, zdrop):
    """Run both kernels on the same lanes; returns the number of lanes
    whose six outputs differ anywhere (the tolerance is zero)."""
    from bioseqdb_tpu.kernels.sw_cuda import sw_extend_batch_cuda

    want = run_xla(*args, end_bonus=end_bonus, zdrop=zdrop)
    q, qlen, t, tlen, w0, h0 = (jnp.asarray(a) for a in args)
    got = sw_extend_batch_cuda(q, qlen, t, tlen, w0, h0, match_score=1,
                               mismatch_penalty=4, end_bonus=end_bonus,
                               zdrop=zdrop, **GAPS)
    bad = np.zeros(len(args[1]), bool)
    for k, v in want.items():
        bad |= np.asarray(got[k]) != v
    return int(bad.sum())


def kernel_model(q_t, qlen, t_t, tlen, w0, h0, mat, o_del, e_del, o_ins,
                 e_ins, end_bonus, zdrop):
    """Python transcription of sw_extend_kernel (one lane at a time, the
    same statements in the same order) on to_kernel_layout's operands."""
    Q, B = q_t.shape
    T = t_t.shape[0]
    smat = np.zeros((5, 6), np.int64)
    smat[:, :5] = mat
    max_sc = int(mat.max())
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    out = np.zeros((6, B), np.int64)
    for lane in range(B):
        ql, tl, hh0 = min(int(qlen[lane]), Q), min(int(tlen[lane]), T), int(h0[lane])
        f32 = np.float32
        max_ins = int(f32(ql * max_sc + end_bonus - o_ins) / f32(e_ins) + f32(1))
        max_del = int(f32(ql * max_sc + end_bonus - o_del) / f32(e_del) + f32(1))
        w = min(int(w0[lane]), max(max_ins, 1), max(max_del, 1))
        H = np.full(Q + 2, -999, np.int64)  # unset cells must never be read
        E = np.full(Q + 2, -999, np.int64)
        score, max_i, max_j, max_ie, gscore, max_off = hh0, -1, -1, -1, -1, 0
        if tl > 0 and ql > 0:
            for j in range(min(ql + 1, Q)):
                h = hh0 if j == 0 else hh0 - oe_ins - e_ins * (j - 1)
                H[j], E[j] = max(h, 0), 0
            beg, end, i = 0, ql, 0
            while True:
                beg = max(beg, i - w)
                end = min(end, i + w + 1, ql)
                srow = smat[min(int(t_t[i, lane]), 4)]
                h1 = max(hh0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
                f, row_max, row_j = 0, -1, -1
                for j in range(beg, end):
                    assert H[j] != -999 and E[j] != -999, (lane, i, j)
                    c_h, c_e = int(H[j]), int(E[j])
                    m = c_h + int(srow[q_t[j, lane]]) if c_h else 0
                    h = max(m, c_e, f)
                    H[j], E[j] = h1, max(c_e - e_del, m - oe_del, 0)
                    h1 = h
                    if h >= row_max:
                        row_max, row_j = h, j
                    f = max(f - e_ins, m - oe_ins, 0)
                H[end], E[end] = (h1 if end < Q else 0), 0
                if end + 1 <= ql:
                    H[end + 1], E[end + 1] = 0, 0
                if end == ql and gscore <= h1:
                    gscore, max_ie = h1, i
                m_best = max(row_max, 0)
                mj = row_j if m_best > 0 else -1
                improved = m_best > score
                di, dj = i - max_i, mj - max_j
                zd = (score - m_best - (di - dj) * e_del > zdrop if di > dj
                      else score - m_best - (dj - di) * e_ins > zdrop)
                break_z = not improved and zdrop > 0 and zd
                if improved:
                    max_off = max(max_off, abs(mj - i))
                    score, max_i, max_j = m_best, i, mj
                if m_best == 0 or break_z or i + 1 >= tl:
                    break
                live = [j for j in range(beg, end + 1) if H[j] or E[j]]
                if not live:
                    beg, end = end, min(beg + 1, ql)
                else:
                    beg, end = live[0], min(live[-1] + 2, ql)
                i += 1
        out[:, lane] = (score, max_j + 1, max_i + 1, max_ie + 1, gscore,
                        max_off)
    return out


@pytest.mark.parametrize(
    "platform, kernel", [("gpu", "cuda"), ("cpu", "xla"), ("METAL", None),
                         ("rocm", None)])
def test_sw_kernel_for(platform, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="no banded-SW kernel"):
            sw_kernel_for(platform)
    else:
        assert sw_kernel_for(platform) == kernel


def test_kernel_layout_casts_and_codes():
    """to_kernel_layout: lane-minor uint8 codes, out-of-range query codes
    -> 5, target codes clipped to 0..4, per-lane vectors int32 even from
    int64 inputs; and the XLA kernel scores the mapped codes exactly as
    the raw ones (5 scores 0 like any code outside its profile)."""
    rng = np.random.default_rng(7)
    B, Q, T = 24, 40, 70
    q = rng.integers(-2, 8, (B, Q)).astype(np.int64)
    t = rng.integers(-2, 8, (B, T)).astype(np.int64)
    qlen = rng.integers(1, Q + 1, B)
    tlen = rng.integers(1, T + 1, B)
    w0 = np.full(B, 100)
    h0 = rng.integers(10, 60, B)
    with jax.enable_x64():
        qt, ql, tt, tl, w, h = to_kernel_layout(q, qlen, t, tlen, w0, h0)
    assert qt.shape == (Q, B) and tt.shape == (T, B)
    assert qt.dtype == jnp.uint8 and tt.dtype == jnp.uint8
    assert all(x.dtype == jnp.int32 for x in (ql, tl, w, h))
    qt, tt = np.asarray(qt), np.asarray(tt)
    assert (qt.T == np.where((q >= 0) & (q <= 4), q, 5)).all()
    assert (tt.T == np.clip(t, 0, 4)).all()
    raw = run_xla(q.astype(np.int32), qlen, t.astype(np.int32), tlen, w0, h0)
    mapped = run_xla(qt.T.astype(np.int32), qlen, tt.T.astype(np.int32),
                     tlen, w0, h0)
    for k in raw:
        assert (raw[k] == mapped[k]).all(), k


@pytest.mark.parametrize("sweep", SWEEPS[:5], ids=[s[0] for s in SWEEPS[:5]])
def test_kernel_model_matches_xla(sweep):
    """The kernel's row loop, transcribed, equals the XLA kernel on every
    lane: the tie rule, the zeroed cells past the band and the missing
    column max_qlen are the XLA kernel's, not the scalar loop's."""
    args, kw = sweep_inputs(sweep)
    want = run_xla(*args, **kw)
    qt, ql, tt, tl, w, h = (np.asarray(a) for a in to_kernel_layout(*args))
    got = kernel_model(qt, ql, tt, tl, w, h, fill_scmat(1, 4), **GAPS, **kw)
    for r, k in enumerate(("score", "qle", "tle", "gtle", "gscore",
                           "max_off")):
        assert (got[r] == want[k]).all(), k


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; python3 chip_smoke.py runs this "
                    "sweep on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("sweep", SWEEPS, ids=[s[0] for s in SWEEPS])
def test_cuda_kernel_matches_xla(gpu, sweep):
    args, kw = sweep_inputs(sweep)
    assert compare_cuda_to_xla(args, **kw) == 0
