"""heat_tpu_torch's order statistics, moments and histograms against
heat_tpu's, on the CPU at world size 1; and the selection behind the
split-axis order statistics against numpy.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)``; each case compares values, dtype, ``gshape``,
``split`` and ``lshape_map``. Tolerances:

- exact (bit for bit): ``percentile`` (all five interpolations, scalar and
  vector q, keepdims, NaN), ``median``, the histograms' counts (``histc``,
  ``histogram``, ``bincount``, ``bucketize``, ``digitize``): they select
  elements or count them, and the arithmetic on the selected values (the
  lerp, the midpoint) is one IEEE operation per step in both packages;
- ``histogram``'s float32 bin edges within 2 ulp (rtol 2.4e-7): both
  packages compute ``jnp.linspace``'s ``lo·(1 - s) + hi·s``, but XLA's CPU
  fusion of it does not round each step as IEEE does, and the port does.
  The counts stay exact: no value of the float data lies between the two
  packages' versions of an edge, and over ``range=(-50, 50)`` the integer
  data's edges round off the multiples of 10 to the same side in both.
- float32 reassociation for ``average``/``nanmean``/``cov``/``skew``/
  ``kurtosis`` (sums added in another order than XLA's): rtol 1e-5 and
  atol 1e-6 for the means and covariances, rtol 1e-4 and atol 1e-5 for
  skew and kurtosis, whose 3rd and 4th powers of deviations cancel
  further.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.parallel.dselect import select_values


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _rng(seed):
    return np.random.default_rng(seed)


X = _rng(0).normal(size=(91, 6)).astype(np.float32)
X64 = _rng(1).normal(size=(40, 3))
XI = _rng(2).integers(-50, 50, size=(33, 4)).astype(np.int32)
EVEN = _rng(3).normal(size=(20, 5)).astype(np.float32)
NAN = X.copy()
NAN[5, 1] = NAN[60, 4] = np.nan
W = _rng(4).uniform(0.5, 2.0, size=91)
LABELS = _rng(5).integers(0, 7, size=50).astype(np.int64)
HX = (_rng(6).normal(size=(64, 3)) * 3).astype(np.float32)
HX[0, 0] = -9.0  # the range's lower edge
HX[1, 0] = 9.0   # the upper edge: the last bin is closed


def _same(t, j, rtol=0.0, atol=0.0, what=""):
    if isinstance(j, (tuple, list)):
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, rtol, atol, f"{what}[{i}]")
        return
    assert t.dtype.__name__ == j.dtype.__name__, f"{what}: dtype {t.dtype} vs {j.dtype}"
    assert tuple(t.gshape) == tuple(j.gshape), f"{what}: gshape {t.gshape} vs {j.gshape}"
    assert t.split == j.split, f"{what}: split {t.split} vs {j.split}"
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map, err_msg=what)
    got, want = t.numpy(), np.asarray(j.numpy())
    if rtol or atol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


EXACT = {
    "percentile_q": lambda ht: ht.percentile(ht.array(X, split=0), [0, 25, 30, 50, 75, 99.9, 100], axis=0),
    "percentile_scalar": lambda ht: ht.percentile(ht.array(X), 30),
    "percentile_ax1": lambda ht: ht.percentile(ht.array(X, split=0), 42.5, axis=1),
    "percentile_kd": lambda ht: ht.percentile(ht.array(X, split=1), [10, 90], axis=0, keepdims=True),
    "percentile_kd_none": lambda ht: ht.percentile(ht.array(X), [10, 90], keepdim=True),
    "percentile_lower": lambda ht: ht.percentile(ht.array(X, split=0), [30, 70], axis=0, interpolation="lower"),
    "percentile_higher": lambda ht: ht.percentile(ht.array(X, split=0), [30, 70], axis=0, interpolation="higher"),
    "percentile_nearest": lambda ht: ht.percentile(ht.array(EVEN), [12.5, 37.5, 50, 62.5], axis=0,
                                                   interpolation="nearest"),
    "percentile_midpoint": lambda ht: ht.percentile(ht.array(X, split=0), [30, 70], axis=0,
                                                    interpolation="midpoint"),
    "percentile_f64": lambda ht: ht.percentile(ht.array(X64, split=0), [1, 33, 66], axis=0),
    "percentile_int": lambda ht: ht.percentile(ht.array(XI, split=0), [5, 50, 95], axis=0),
    "percentile_nan": lambda ht: ht.percentile(ht.array(NAN, split=0), [25, 75], axis=0),
    "percentile_tuple": lambda ht: ht.percentile(ht.array(X[:12].reshape(3, 4, 6)), [20, 80], axis=(0, 2)),
    "median": lambda ht: ht.median(ht.array(X, split=0), axis=0),
    "median_even": lambda ht: ht.median(ht.array(EVEN, split=1), axis=0),
    "median_none": lambda ht: ht.median(ht.array(EVEN)),
    "median_kd": lambda ht: ht.median(ht.array(EVEN, split=0), axis=1, keepdims=True),
    "median_int": lambda ht: ht.median(ht.array(XI), axis=0),
    "median_nan": lambda ht: ht.median(ht.array(NAN), axis=0),
    "median_f64": lambda ht: ht.median(ht.array(X64), axis=0),
    "histc": lambda ht: ht.histc(ht.array(HX, split=0), bins=9, min=-4.0, max=4.0),
    "histc_auto": lambda ht: ht.histc(ht.array(HX[:, 2]), bins=5),
    "histc_int": lambda ht: ht.histc(ht.array(XI, split=0), bins=10, min=-50, max=50),
    "bincount": lambda ht: ht.bincount(ht.array(LABELS, split=0)),
    "bincount_minlength": lambda ht: ht.bincount(ht.array(LABELS), minlength=12),
    "bincount_weights": lambda ht: ht.bincount(ht.array(LABELS, split=0), weights=ht.array(W[:50], split=0)),
    "bucketize": lambda ht: ht.bucketize(ht.array(HX, split=0), [-2.0, 0.0, 1.5]),
    "bucketize_right": lambda ht: ht.bucketize(ht.array(np.round(HX), split=0), [-2.0, 0.0, 1.0], right=True,
                                               out_int32=True),
    "digitize": lambda ht: ht.digitize(ht.array(HX, split=1), [-2.0, 0.0, 1.5]),
    "digitize_right": lambda ht: ht.digitize(ht.array(np.round(HX)), [-2.0, 0.0, 1.0], right=True),
    "digitize_decreasing": lambda ht: ht.digitize(ht.array(HX[:, 0], split=0), [3.0, 0.0, -1.0]),
}

HISTOGRAMS = {
    "histogram": lambda ht: ht.histogram(ht.array(HX[:, 0], split=0), bins=6, range=(-9.0, 9.0)),
    "histogram_auto": lambda ht: ht.histogram(ht.array(HX, split=0), bins=7),
    "histogram_density": lambda ht: ht.histogram(ht.array(HX[:, 1]), bins=4, density=True),
    "histogram_int_auto": lambda ht: ht.histogram(ht.array(XI.astype(np.float32) + 0.5), bins=5),
    "histogram_int": lambda ht: ht.histogram(ht.array(XI), bins=10, range=(-50, 50)),
}

CLOSE = {
    "average": (lambda ht: ht.average(ht.array(X, split=0), axis=0), 1e-5, 1e-6),
    "average_none": (lambda ht: ht.average(ht.array(X)), 1e-5, 1e-6),
    "average_weights": (lambda ht: ht.average(ht.array(X, split=0), axis=0, weights=W), 1e-5, 1e-6),
    "average_weights_full": (lambda ht: ht.average(ht.array(X, split=1), weights=ht.array(X * 0 + 2.0, split=1)),
                             1e-5, 1e-6),
    "average_returned": (lambda ht: ht.average(ht.array(X, split=0), axis=0, weights=W, returned=True), 1e-5, 1e-5),
    "average_returned_plain": (lambda ht: ht.average(ht.array(X), axis=1, returned=True), 1e-5, 1e-6),
    "nanmean": (lambda ht: ht.nanmean(ht.array(NAN, split=0), axis=0), 1e-5, 1e-6),
    "nanmean_none": (lambda ht: ht.nanmean(ht.array(NAN)), 1e-5, 1e-6),
    "nanmean_kd": (lambda ht: ht.nanmean(ht.array(NAN, split=1), axis=1, keepdims=True), 1e-5, 1e-6),
    "nanmean_int": (lambda ht: ht.nanmean(ht.array(XI), axis=0), 1e-5, 1e-6),
    "cov_rows": (lambda ht: ht.cov(ht.array(X[:6].T.copy(), split=0)), 1e-5, 1e-6),
    "cov_cols": (lambda ht: ht.cov(ht.array(X, split=0), rowvar=False), 1e-5, 1e-6),
    "cov_bias": (lambda ht: ht.cov(ht.array(X, split=1), rowvar=False, bias=True), 1e-5, 1e-6),
    "cov_y": (lambda ht: ht.cov(ht.array(X[:, 0]), ht.array(X[:, 1])), 1e-5, 1e-6),
    "cov_ddof": (lambda ht: ht.cov(ht.array(X64, split=0), rowvar=False, ddof=2), 1e-12, 1e-14),
    "skew": (lambda ht: ht.skew(ht.array(X, split=0), axis=0), 1e-4, 1e-5),
    "skew_none": (lambda ht: ht.skew(ht.array(X)), 1e-4, 1e-5),
    "skew_biased": (lambda ht: ht.skew(ht.array(X, split=1), axis=1, unbiased=False), 1e-4, 1e-5),
    "kurtosis": (lambda ht: ht.kurtosis(ht.array(X, split=0), axis=0), 1e-4, 1e-5),
    "kurtosis_pearson": (lambda ht: ht.kurtosis(ht.array(X), axis=1, Fischer=False), 1e-4, 1e-5),
    "kurtosis_biased": (lambda ht: ht.kurtosis(ht.array(X64), unbiased=False), 1e-12, 1e-14),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_matches_heat_tpu_exactly(name):
    _same(EXACT[name](htt), EXACT[name](htj), what=name)


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_histogram_counts_exact_and_edges_within_two_ulp(name):
    (counts, edges), (jc, je) = HISTOGRAMS[name](htt), HISTOGRAMS[name](htj)
    _same(counts, jc, rtol=1e-6 if "density" in name else 0.0, what=name)
    _same(edges, je, rtol=2.4e-7, what=name)


@pytest.mark.parametrize("name", sorted(CLOSE))
def test_matches_heat_tpu_within_reassociation(name):
    call, rtol, atol = CLOSE[name]
    _same(call(htt), call(htj), rtol=rtol, atol=atol, what=name)


@pytest.mark.parametrize("name, call", [
    ("q_range", lambda ht: ht.percentile(ht.array(X), 101)),
    ("q_nan", lambda ht: ht.percentile(ht.array(X), np.nan)),
    ("not_array", lambda ht: ht.median(X)),
    ("zero_weights", lambda ht: ht.average(ht.array(X), axis=0, weights=np.zeros(91))),
    ("zero_weights_dnd", lambda ht: ht.average(ht.array(X), axis=0, weights=ht.array(np.zeros(91)))),
    ("weights_shape", lambda ht: ht.average(ht.array(X), weights=W)),
])
def test_raises_as_heat_tpu(name, call):
    with pytest.raises(Exception) as want:
        call(htj)
    with pytest.raises(Exception) as got:
        call(htt)
    assert type(got.value).__name__ == type(want.value).__name__, (got.value, want.value)


def test_a_chunk_iterator_names_the_stream_module():
    """A real ChunkIterator streams through the KLL sketch (its values are
    held in tests/test_torch_sketch.py); any other object that is not an
    array is refused with a TypeError that names the stream's
    ChunkIterator, as heat_tpu refuses it."""
    class ChunkIterator:
        pass

    for mod in (htt, htj):
        for fn in (lambda c: mod.median(c), lambda c: mod.percentile(c, 50)):
            with pytest.raises(TypeError, match="ChunkIterator"):
                fn(ChunkIterator())
    it = htt.stream.ChunkIterator(np.arange(1000, dtype=np.float32).reshape(250, 4), 64, device="cpu")
    sk = htt.stream.KLLSketch()
    for chunk in it:
        sk.update(chunk)
    assert abs(float(htt.median(it).item()) - 499.5) <= 1000 * sk.eps


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_selection_equals_the_sorted_values(dtype):
    """Every rank of every column (and of two segments) against numpy's
    sort, with NaN, infinities, signed zeros and ties."""
    rng = _rng(7)
    x = (rng.normal(size=(257, 3)) * 1e3).astype(dtype)
    x[:40] = x[40:80]  # ties
    if np.issubdtype(dtype, np.floating):
        x[3, 0], x[9, 1], x[11, 2], x[12, 2] = np.inf, -np.inf, -0.0, 0.0
    seg = rng.integers(0, 2, size=257)
    t = torch.from_numpy(x)
    ranks = torch.arange(257).reshape(-1, 1, 1).expand(-1, 1, 3).contiguous()
    got = select_values(t, ranks).numpy()[:, 0]
    np.testing.assert_array_equal(got, np.sort(x, axis=0))
    for s in (0, 1):
        rows = x[seg == s]
        tg = torch.arange(rows.shape[0]).reshape(-1, 1).expand(-1, 3)
        targets = torch.zeros((rows.shape[0], 2, 3), dtype=torch.int64)
        targets[:, s] = tg
        got = select_values(t, targets, seg=torch.from_numpy(seg)).numpy()[:, s]
        np.testing.assert_array_equal(got, np.sort(rows, axis=0))


def test_selection_puts_nan_last():
    x = np.array([[3.0], [np.nan], [-1.0], [2.0]], dtype=np.float32)
    got = select_values(torch.from_numpy(x), torch.arange(4).reshape(4, 1, 1)).numpy().ravel()
    np.testing.assert_array_equal(got[:3], [-1.0, 2.0, 3.0])
    assert np.isnan(got[3])
