"""heat_tpu_torch's kNN path against heat_tpu, on the CPU.

The same numpy inputs, made from a seed, go through both packages:
``spatial.nearest_neighbors`` over every split combination,
``KNeighborsClassifier.fit``/``predict`` through both of its routes, and
the conversion of a fitted heat_tpu classifier. Tolerances: distances
rtol 1e-4 / atol 1e-5 (the bound heat_tpu's own kNN tests use); indices
exact outside near-ties, where the two rows' distances are within 1e-5 of
each other relative to (d + 1); labels exact on well-separated blobs.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj

import heat_tpu_torch as htt
from heat_tpu_torch import convert
from heat_tpu_torch.classification import kneighborsclassifier as tknn
from heat_tpu_torch.spatial.distance import _quadratic_expand

KNN_TIE_RTOL = 1e-5


@pytest.fixture
def cpu():
    """Run the port on the CPU for one test, then restore the default."""
    htt.use_device("cpu")
    htt.kernels.reset_kernel_stats()
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


def _blobs(seed, n, f, k, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * scale).astype(np.float32)
    member = rng.integers(0, k, size=n)
    return (centers[member] + rng.normal(size=(n, f))).astype(np.float32), member.astype(np.int32)


def _same_neighbours(x, y, d, i, d_ref, i_ref):
    np.testing.assert_allclose(d, d_ref, rtol=1e-4, atol=1e-5)
    diff = i != i_ref
    if diff.any():
        full = _quadratic_expand(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        rows = np.nonzero(diff.any(axis=1))[0]
        dk = np.take_along_axis(full[rows], i[rows].astype(np.int64), 1)
        dr = np.take_along_axis(full[rows], i_ref[rows].astype(np.int64), 1)
        assert (np.abs(dk - dr) <= KNN_TIE_RTOL * (np.abs(dr) + 1.0)).all(), "indices differ outside near-ties"


# ---------------------------------------------------------- nearest_neighbors
@pytest.mark.parametrize("sx", [None, 0])
@pytest.mark.parametrize("sy", [None, 0])
def test_nearest_neighbors_matches_heat_tpu(cpu, sx, sy):
    rng = np.random.default_rng(23)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.normal(size=(203, 8)).astype(np.float32)
    dj, ij = htj.spatial.nearest_neighbors(htj.array(x, split=sx), htj.array(y, split=sy), 3)
    dt, it = htt.spatial.nearest_neighbors(htt.array(x, split=sx), htt.array(y, split=sy), 3)
    assert dt.split == it.split == dj.split == sx
    assert dt.dtype is htt.float32 and it.dtype is htt.int32 and dt.gshape == it.gshape == (64, 3)
    assert dt.dtype.__name__ == dj.dtype.__name__ and it.dtype.__name__ == ij.dtype.__name__
    _same_neighbours(x, y, dt.numpy(), it.numpy(), dj.numpy(), ij.numpy())
    assert htt.KERNEL_STATS == {"dispatches": 1, "topk_distance.torch": 1}


def test_nearest_neighbors_k_equals_m_and_errors(cpu):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(20, 4)).astype(np.float32)
    dj, ij = htj.spatial.nearest_neighbors(htj.array(x), htj.array(y), 20)
    dt, it = htt.spatial.nearest_neighbors(htt.array(x), htt.array(y), 20)
    _same_neighbours(x, y, dt.numpy(), it.numpy(), dj.numpy(), ij.numpy())
    with pytest.raises(ValueError, match="k="):
        htt.spatial.nearest_neighbors(htt.array(x), htt.array(y), 21)
    with pytest.raises(NotImplementedError):
        htt.spatial.nearest_neighbors(htt.array(x, split=1), htt.array(y), 2)
    with pytest.raises(NotImplementedError):
        htt.spatial.nearest_neighbors(htt.array(x[0]), htt.array(y), 2)


# ----------------------------------------------------------- the classifier
def _fit_both(x, y, k, split=None):
    cj = htj.classification.KNeighborsClassifier(n_neighbors=k).fit(htj.array(x, split=split), htj.array(y, split=split))
    ct = htt.classification.KNeighborsClassifier(n_neighbors=k).fit(htt.array(x, split=split), htt.array(y, split=split))
    return cj, ct


@pytest.mark.parametrize("split", [None, 0])
def test_classifier_materializing_route_matches_heat_tpu(cpu, split):
    x, y = _blobs(0, 300, 5, 4)
    q, q_member = _blobs(0, 400, 5, 4)  # same centres, new points
    q, q_member = q[300:], q_member[300:]
    cj, ct = _fit_both(x, y, 5, split)
    np.testing.assert_array_equal(ct.classes_.numpy(), np.asarray(cj.classes_))
    pj = cj.predict(htj.array(q, split=split))
    htt.kernels.reset_kernel_stats()
    pt = ct.predict(htt.array(q, split=split))
    assert htt.KERNEL_STATS == {"dispatches": 1, "topk_distance.fallback": 1}
    assert pt.split == pj.split == split and pt.dtype.__name__ == pj.dtype.__name__ == "int32"
    np.testing.assert_array_equal(pt.numpy(), pj.numpy())
    assert (pt.numpy() == q_member).mean() > 0.99


def test_classifier_fused_route_matches_heat_tpu(cpu, monkeypatch):
    """More than 2^22 query-training pairs: the fused route, which the
    port takes for tensors on a card, driven here through the plain
    version by declaring the CPU tensor kernel-capable."""
    x, y = _blobs(1, 2049, 3, 3)
    q, _ = _blobs(2, 2048, 3, 3)
    cj, ct = _fit_both(x, y, 5, 0)
    monkeypatch.setattr(tknn, "_on_card", lambda t: True)
    pt = ct.predict(htt.array(q, split=0))
    assert htt.KERNEL_STATS == {"dispatches": 1, "topk_distance.torch": 1}
    assert pt.split == 0 and pt.gshape == (2048,)
    np.testing.assert_array_equal(pt.numpy(), cj.predict(htj.array(q, split=0)).numpy())


@pytest.mark.parametrize("k,nq,split", [(65, 2048, 0), (5, 2047, 0), (5, 2047, None)])  # k > 64, too few pairs
def test_classifier_gate_takes_the_materializing_route(cpu, monkeypatch, k, nq, split):
    x, y = _blobs(3, 2049, 3, 3)
    q, _ = _blobs(4, nq, 3, 3)
    cj, ct = _fit_both(x, y, k)
    monkeypatch.setattr(tknn, "_on_card", lambda t: True)
    pt = ct.predict(htt.array(q, split=split))
    assert htt.KERNEL_STATS == {"dispatches": 1, "topk_distance.fallback": 1}
    np.testing.assert_array_equal(pt.numpy(), cj.predict(htj.array(q, split=split)).numpy())


def test_classifier_column_split_queries_raise_as_in_heat_tpu(cpu):
    """A 1-D prediction cannot carry the queries' split 1: both packages
    raise ValueError."""
    x, y = _blobs(8, 40, 3, 2)
    cj, ct = _fit_both(x, y, 3)
    with pytest.raises(ValueError):
        cj.predict(htj.array(x, split=1))
    with pytest.raises(ValueError):
        ct.predict(htt.array(x, split=1))


def test_classifier_vote_ties_go_to_the_smallest_label(cpu):
    x = np.array([[0.0], [1.0], [-1.0], [2.0], [-2.0]], dtype=np.float32)
    y = np.array([7, 3, 7, 3, 9], dtype=np.int32)
    cj, ct = _fit_both(x, y, 4)
    q = np.array([[0.1], [-0.1], [5.0]], dtype=np.float32)
    pt = ct.predict(htt.array(q)).numpy()
    np.testing.assert_array_equal(pt, cj.predict(htj.array(q)).numpy())
    assert pt[0] == 3  # 2 votes each for 3 and 7


def test_classifier_api(cpu):
    clf = htt.classification.KNeighborsClassifier()
    assert clf.n_neighbors == 5 and htt.is_classifier(clf) and clf.get_params() == {"n_neighbors": 5}
    with pytest.raises(RuntimeError):
        clf.predict(htt.zeros((2, 3)))
    with pytest.raises(TypeError):
        clf.fit(np.zeros((2, 3)), htt.zeros(2))
    x, y = _blobs(5, 60, 2, 2)
    clf.fit(htt.array(x), htt.array(y))
    np.testing.assert_array_equal(clf.fit_predict(htt.array(x), htt.array(y)).numpy(), y)


# ---------------------------------------------------------------- convert
@pytest.mark.parametrize("split", [None, 0])
def test_knn_from_heat_tpu(cpu, split):
    x, y = _blobs(6, 200, 4, 3)
    q, _ = _blobs(7, 50, 4, 3)
    cj = htj.classification.KNeighborsClassifier(n_neighbors=7).fit(htj.array(x, split=split), htj.array(y, split=split))
    ct = convert.knn_from_heat_tpu(cj.x.numpy(), cj.y.numpy(), n_neighbors=cj.n_neighbors, split=cj.x.split)
    assert isinstance(ct, htt.classification.KNeighborsClassifier) and ct.n_neighbors == 7
    assert ct.x.split == split and ct.x.dtype is htt.float32 and ct.y.dtype is htt.int32
    np.testing.assert_array_equal(ct.x.numpy(), x)
    np.testing.assert_array_equal(ct.predict(htt.array(q)).numpy(), cj.predict(htj.array(q)).numpy())
    with pytest.raises(ValueError):
        convert.knn_from_heat_tpu(x, y[:-1])
