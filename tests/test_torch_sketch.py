"""heat_tpu_torch's streaming sketches on the CPU: HyperLogLog registers
and Count-Min tables and candidates against heat_tpu's, KLL quantiles
against numpy within the sketch's own bound.

heat_tpu runs under ``comm_context(SELF)``. Its KLL fold is never called
here: it aborts inside jax now and then and takes a test worker down with
it. The KLL sketch is held to its promise instead: every quantile's rank
in the exact sorted data lies within ``eps * n`` of the asked rank
(``eps`` the sketch's own conservative bound, ``docs/STREAMING.md``).

Tolerances: registers, tables, candidates and counts exact (integer
state from exact uint32 hashes); the HLL estimate within 3 of its
relative standard errors; KLL ranks within ``eps * n``.
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

_rng = np.random.default_rng(31)
SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 3.4e38, 1e-45, -1e-40, -1e-45], np.float32)


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _fold(pkg, sketch, data, rows, **kw):
    for c in pkg.stream.ChunkIterator(data, rows, **kw):
        sketch.update(c)
    return sketch


# --------------------------------------------------------------- HyperLogLog
@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hll_registers_equal_heat_tpus(p, dtype):
    data = np.concatenate([_rng.integers(0, 3000, size=4000).astype(dtype), SPECIAL.astype(dtype)]).reshape(-1, 1)
    t = _fold(htt, htt.stream.HyperLogLog(p), data, 500, dtype=getattr(htt, dtype))
    j = _fold(htj, htj.stream.HyperLogLog(p), data, 500, dtype=getattr(htj, dtype))
    np.testing.assert_array_equal(t._regs.numpy(), np.asarray(j._regs))
    assert t.distinct() == pytest.approx(j.distinct(), rel=1e-6)
    assert t.rel_error == j.rel_error


def test_hll_estimate_within_three_sigma_and_merge():
    truth = 20000
    data = _rng.permutation(np.repeat(np.arange(truth, dtype=np.float32), 3)).reshape(-1, 4)
    a = _fold(htt, htt.stream.HyperLogLog(12), data[:7000], 1024)
    b = _fold(htt, htt.stream.HyperLogLog(12), data[7000:], 1024)
    one = _fold(htt, htt.stream.HyperLogLog(12), data, 1024)
    a.merge(b)
    np.testing.assert_array_equal(a._regs.numpy(), one._regs.numpy())
    assert abs(one.distinct() - truth) <= 3 * one.rel_error * truth


# -------------------------------------------------------------- Count-Min
@pytest.mark.parametrize("width,depth,k", [(64, 2, 8), (2048, 4, 64), (512, 8, 16)])
def test_count_min_tables_and_candidates_equal_heat_tpus(width, depth, k):
    zipf = np.minimum(_rng.zipf(1.6, size=6000), 500).astype(np.float32)
    data = np.concatenate([zipf, SPECIAL, SPECIAL[:1]]).reshape(-1, 3)
    t = _fold(htt, htt.stream.CountMinTopK(width, depth, k), data, 400)
    j = _fold(htj, htj.stream.CountMinTopK(width, depth, k), data, 400)
    np.testing.assert_array_equal(t._table.numpy(), np.asarray(j._table).astype(np.int64))
    np.testing.assert_array_equal(t._cands.numpy(), np.asarray(j._cands))
    for kk in (1, k):
        (tv, tc), (jv, jc) = t.topk(kk), j.topk(kk)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc.numpy()))
        assert tc.dtype.__name__ == jc.dtype.__name__
    for v in (1.0, 2.0, 499.0, 12345.0):
        assert t.estimate(v) == j.estimate(v)
    assert t.items == j.items and t.eps == j.eps


def test_count_min_recovers_the_true_heavy_hitters_and_merges():
    zipf = _rng.zipf(1.3, size=20000).astype(np.float32).reshape(-1, 2)
    one = _fold(htt, htt.stream.CountMinTopK(2048, 4, 32), zipf, 1000)
    a = _fold(htt, htt.stream.CountMinTopK(2048, 4, 32), zipf[:4000], 1000)
    b = _fold(htt, htt.stream.CountMinTopK(2048, 4, 32), zipf[4000:], 1000)
    a.merge(b)
    np.testing.assert_array_equal(a._table.numpy(), one._table.numpy())
    vals, counts = np.unique(zipf, return_counts=True)
    top5 = set(vals[np.argsort(-counts, kind="stable")][:5].tolist())
    assert top5 <= set(one.topk(10)[0].numpy().tolist())
    est = one.topk(5)[1].numpy()
    true = np.sort(counts)[::-1][:5]
    assert np.all(est >= true) and np.all(est <= true + one.eps * one.items)


# ---------------------------------------------------------------------- KLL
def _rank_error(sorted_x, value, q):
    """How far (as a fraction of n) the rank of ``value`` in the sorted
    data lies from ``q`` (the closest rank among its ties)."""
    n = sorted_x.size
    lo = np.searchsorted(sorted_x, value, side="left")
    hi = np.searchsorted(sorted_x, value, side="right")
    target = q * (n - 1)
    return max(0.0, lo - target, target - hi) / n


@pytest.mark.parametrize("n,rows", [(4096, 256), (4000, 333), (3000, 3000)])
@pytest.mark.parametrize("k", [32, 256])
def test_kll_quantiles_within_eps_of_numpys(n, rows, k):
    x = np.concatenate([_rng.normal(size=n // 2), _rng.exponential(3.0, size=n - n // 2)]).astype(np.float32)
    x = x.reshape(-1, 2) if n % 2 == 0 else x[:, None]
    sk = _fold(htt, htt.stream.KLLSketch(k=k), x, rows)
    qs = np.array([0, 1, 10, 25, 50, 75, 90, 99, 100], np.float64)
    got = sk.percentile(qs).numpy()
    sx = np.sort(x.ravel())
    for q, v in zip(qs / 100, got):
        assert _rank_error(sx, v, q) <= sk.eps, (q, v, sk.eps)
    assert sk.n == x.shape[0] and sk.median().numpy() == sk.percentile(50).numpy()


def test_kll_through_percentile_and_median_of_a_chunk_iterator_and_merge():
    x = _rng.uniform(-5, 5, size=(3000, 3)).astype(np.float32)
    it = htt.stream.ChunkIterator(x, 250)
    sk = _fold(htt, htt.stream.KLLSketch(), x, 250)
    np.testing.assert_array_equal(htt.percentile(it, [5, 50, 95]).numpy(), sk.percentile([5, 50, 95]).numpy())
    np.testing.assert_array_equal(htt.median(it).numpy(), sk.median().numpy())
    with pytest.raises(ValueError):
        htt.percentile(it, 50, axis=0)
    a = _fold(htt, htt.stream.KLLSketch(), x[:1000], 250)
    b = _fold(htt, htt.stream.KLLSketch(), x[1000:], 250)
    a.merge(b)
    sx = np.sort(x.ravel())
    for q in (0.1, 0.5, 0.9):
        assert _rank_error(sx, float(a.percentile(100 * q).numpy()), q) <= a.eps + 1 / 256


def test_kll_state_geometry_and_eps_accounting_match_heat_tpu():
    """The level stack's shape and eps formula (the state heat_tpu's merge
    takes), without folding through heat_tpu."""
    for k, levels, folds in ((256, 12, 1), (64, 4, 9), (8, 2, 5)):
        t, j = htt.stream.KLLSketch(k, levels), htj.stream.KLLSketch(k, levels)
        t._folds = j._folds = folds
        assert t.eps == j.eps
    with pytest.raises(ValueError):
        htt.stream.KLLSketch(k=4)
