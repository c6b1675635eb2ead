"""heat_tpu_torch's ``KMedians`` and ``KMedoids`` against heat_tpu's, on
the CPU at world size 1, and their centre update against numpy.

The same seeded blobs (well separated, so the L1 assignments cannot
differ by rounding) go through both packages, heat_tpu under
``comm_context(SELF)``. Tolerance: exact (bit for bit) for the labels,
the iteration counts, the medoids (rows of the data) and the median
centres: a median is the midpoint ``(lo + hi) * 0.5`` of two elements of
the data in both packages. ``cluster_medians`` is held to
``np.median`` of each cluster's members (the mean of the two middle
values, the same IEEE operations) on ties, NaN and an empty cluster.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.cluster.kmedians import cluster_medians


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _blobs(seed, n, f, k, scale=12.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, f)) * scale
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    return (centres[member] + rng.standard_t(3, size=(n, f))).astype(dtype)


X = _blobs(0, 240, 5, 4)
X64 = _blobs(1, 150, 3, 3, dtype=np.float64)
NEW = _blobs(2, 30, 5, 4)


def _same(t, j, what=""):
    assert t.dtype.__name__ == j.dtype.__name__, f"{what}: dtype {t.dtype} vs {j.dtype}"
    assert tuple(t.gshape) == tuple(j.gshape), f"{what}: gshape {t.gshape} vs {j.gshape}"
    assert t.split == j.split, f"{what}: split {t.split} vs {j.split}"
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map, err_msg=what)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()), err_msg=what)


FITS = {
    "kmedians_explicit": lambda ht: ht.cluster.KMedians(4, init=ht.array(X[:4]), max_iter=20, tol=None),
    "kmedians_tol": lambda ht: ht.cluster.KMedians(4, init=ht.array(X[:4]), max_iter=50, tol=1e-4),
    "kmedians_random": lambda ht: ht.cluster.KMedians(4, init="random", random_state=3, max_iter=15),
    "kmedians_pp": lambda ht: ht.cluster.KMedians(4, init="kmeans++", random_state=2, max_iter=10, tol=None),
    "kmedoids_explicit": lambda ht: ht.cluster.KMedoids(4, init=ht.array(X[:4]), max_iter=20),
    "kmedoids_random": lambda ht: ht.cluster.KMedoids(4, init="random", random_state=7, max_iter=20),
}


@pytest.mark.parametrize("name", sorted(FITS))
@pytest.mark.parametrize("split", [0, None])
def test_fit_matches_heat_tpu(name, split):
    got = FITS[name](htt).fit(htt.array(X, split=split))
    want = FITS[name](htj).fit(htj.array(X, split=split))
    _same(got.cluster_centers_, want.cluster_centers_, f"{name}: centres")
    _same(got.labels_, want.labels_, f"{name}: labels")
    assert got.n_iter_ == want.n_iter_, name
    _same(got.predict(htt.array(NEW, split=0)), want.predict(htj.array(NEW, split=0)), f"{name}: predict")


@pytest.mark.parametrize("cls", ["KMedians", "KMedoids"])
def test_fit_float64_matches_heat_tpu(cls):
    kw = dict(max_iter=10) if cls == "KMedoids" else dict(max_iter=10, tol=None)
    got = getattr(htt.cluster, cls)(3, init=htt.array(X64[:3]), **kw).fit(htt.array(X64, split=0))
    want = getattr(htj.cluster, cls)(3, init=htj.array(X64[:3]), **kw).fit(htj.array(X64, split=0))
    _same(got.cluster_centers_, want.cluster_centers_, cls)
    _same(got.labels_, want.labels_, cls)


def test_kmedians_centres_are_numpys_medians_of_the_members():
    km = htt.cluster.KMedians(4, init=htt.array(X[:4]), max_iter=6, tol=None).fit(htt.array(X, split=0))
    # one more update from the final centres: exactly np.median of the rows those centres assign
    labels = np.argmin(np.abs(X[:, None, :] - km.cluster_centers_.numpy()[None]).sum(-1), axis=1)
    med = cluster_medians(torch.from_numpy(X), torch.from_numpy(labels), 4).numpy()
    for c in range(4):
        np.testing.assert_array_equal(med[c], np.median(X[labels == c], axis=0))


def test_cluster_medians_ties_nan_and_an_empty_cluster():
    x = np.array([[1, 5], [1, np.nan], [3, 2], [2, 2], [9, 9], [7, 1]], dtype=np.float32)
    labels = np.array([0, 0, 0, 0, 2, 2])
    med = cluster_medians(torch.from_numpy(x), torch.from_numpy(labels), 3).numpy()
    np.testing.assert_array_equal(med[0], [np.median([1, 1, 3, 2]), np.median([5, 2, 2])])
    np.testing.assert_array_equal(med[2], np.median(x[4:], axis=0))
    assert np.isnan(med[1]).all()


def test_kmedoids_centres_are_the_members_nearest_to_their_medians():
    """Each medoid is the member with the smallest L1 distance to the
    numpy median of its cluster's members (the first such row on ties)."""
    kd = htt.cluster.KMedoids(4, init="random", random_state=7, max_iter=20).fit(htt.array(X, split=0))
    centres, labels = kd.cluster_centers_.numpy(), kd.labels_.numpy()
    for c in range(4):
        rows = np.nonzero(labels == c)[0]
        med = np.median(X[rows], axis=0)
        near = rows[np.argmin(np.abs(X[rows] - med).sum(axis=1))]
        np.testing.assert_array_equal(centres[c], X[near])


@pytest.mark.parametrize("estimator", ["kmedians", "kmedoids"])
def test_convert_carries_a_fitted_heat_tpu_estimator(estimator):
    cls = "KMedians" if estimator == "kmedians" else "KMedoids"
    want = getattr(htj.cluster, cls)(4, init=htj.array(X[:4]), max_iter=5).fit(htj.array(X, split=0))
    got = htt.convert.from_heat_tpu_state(want.state_dict(), estimator=estimator)
    assert type(got).__name__ == cls and got.n_iter_ == want.n_iter_
    _same(got.cluster_centers_, want.cluster_centers_, estimator)
    _same(got.predict(htt.array(NEW, split=0)), want.predict(htj.array(NEW, split=0)), estimator)


def test_fit_rejects_what_heat_tpu_rejects():
    for ht in (htt, htj):
        with pytest.raises(TypeError):
            ht.cluster.KMedians(2).fit(X)
        with pytest.raises(ValueError):
            ht.cluster.KMedoids(2, max_iter=0).fit(ht.array(X))
