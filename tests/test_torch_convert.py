"""State transfer from heat_tpu into heat_tpu_torch (``heat_tpu_torch.convert``).

A KMeans fitted with heat_tpu exports ``state_dict()`` (numpy arrays and
python scalars); the port's KMeans built from it must predict the same
labels and hold the same centroids (exactly: the values are copied).
"""
import numpy as np
import pytest

import heat_tpu as htj

import heat_tpu_torch as htt
from heat_tpu_torch import convert


@pytest.fixture
def cpu():
    htt.use_device("cpu")
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


def _blobs(seed, n, f, k):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * 10.0).astype(np.float32)
    member = rng.integers(0, k, size=n)
    return (centers[member] + rng.normal(size=(n, f))).astype(np.float32)


@pytest.mark.parametrize("tol", [None, 1e-4])
def test_kmeans_state_from_heat_tpu(cpu, tol):
    x_np = _blobs(0, 120, 4, 3)
    new_np = _blobs(1, 40, 4, 3)
    kmj = htj.cluster.KMeans(n_clusters=3, init="kmeans++", random_state=3, max_iter=20, tol=tol)
    kmj.fit(htj.array(x_np, split=0))
    kmt = convert.from_heat_tpu_state(kmj.state_dict())
    assert isinstance(kmt, htt.cluster.KMeans)
    assert (kmt.n_clusters, kmt.max_iter, kmt.tol, kmt.n_iter_) == (3, 20, tol, kmj.n_iter_)
    assert kmt.inertia_ == pytest.approx(kmj.inertia_)
    np.testing.assert_array_equal(kmt.cluster_centers_.numpy(), kmj.cluster_centers_.numpy())
    assert kmt.cluster_centers_.dtype is htt.float32 and kmt.cluster_centers_.split is None
    np.testing.assert_array_equal(kmt.labels_.numpy(), kmj.labels_.numpy())
    assert kmt.labels_.split == kmj.labels_.split == 0 and kmt.labels_.dtype is htt.int64
    np.testing.assert_array_equal(
        kmt.predict(htt.array(new_np, split=0)).numpy(), kmj.predict(htj.array(new_np, split=0)).numpy()
    )


def test_unfitted_state_and_bad_state(cpu):
    d = htj.cluster.KMeans(n_clusters=4, max_iter=7).state_dict()
    km = convert.from_heat_tpu_state(d)
    assert km.cluster_centers_ is None and km.n_clusters == 4 and km.max_iter == 7
    with pytest.raises(RuntimeError):
        km.predict(htt.zeros((2, 3)))
    with pytest.raises(KeyError):
        convert.from_heat_tpu_state({"n_clusters": 2})


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.bool_])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_array_from_numpy(cpu, dtype, split):
    a = (np.arange(12).reshape(3, 4) % 3).astype(dtype)
    t = convert.array_from_numpy(a, split=split)
    j = htj.array(a, split=split)
    assert t.dtype.__name__ == j.dtype.__name__ and t.split == j.split == split and t.gshape == (3, 4)
    np.testing.assert_array_equal(t.numpy(), a)
