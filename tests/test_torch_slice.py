"""heat_tpu_torch's main-path slice against heat_tpu, on the CPU.

The same numpy inputs, made from a seed, go through both packages: factories
and arithmetic, ``mean``/``var``/``std``, standardization, ``cdist``, and
``KMeans.fit`` from an explicit ``DNDarray`` init, then ``predict``. Values,
dtypes, ``gshape`` and ``split`` must agree; ``lshape_map`` is compared with
a 1-device heat_tpu communicator (the test mesh's 8 devices pad rows).
Tolerances: means 2e-6, second moments 2e-4 (float32 reassociation, the
bounds heat_tpu's own parity tests use), elementwise results 1e-6, fitted
centroids 1e-5, inertia 1e-4; labels exact on well-separated blobs.
"""
import jax
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.core import statistics as tstats


@pytest.fixture
def cpu():
    """Run the port on the CPU for one test, then restore the default."""
    htt.use_device("cpu")
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


def _blobs(seed, n, f, k, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * scale).astype(np.float32)
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    return (centers[member] + rng.normal(size=(n, f))).astype(np.float32), member


def _same_meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split


def _lshape_map_1dev(gshape, split):
    return MeshCommunication(devices=[jax.devices()[0]]).lshape_map(gshape, split)


# ------------------------------------------------------------- the slice
def test_main_path_matches_heat_tpu(cpu):
    n, f, k = 203, 5, 3
    x_np, _ = _blobs(0, n, f, k)
    new_np, member_new = _blobs(1, 64, f, k)
    xj, xt = htj.array(x_np, split=0), htt.array(x_np, split=0)
    _same_meta(xt, xj)
    np.testing.assert_array_equal(xt.lshape_map, _lshape_map_1dev(x_np.shape, 0))

    muj, sdj = htj.mean(xj, axis=0), htj.std(xj, axis=0)
    mut, sdt = htt.mean(xt, axis=0), htt.std(xt, axis=0)
    _same_meta(mut, muj)
    _same_meta(sdt, sdj)
    np.testing.assert_allclose(mut.numpy(), muj.numpy(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(sdt.numpy(), sdj.numpy(), rtol=2e-4)

    zj, zt = (xj - muj) / sdj, (xt - mut) / sdt
    _same_meta(zt, zj)
    np.testing.assert_array_equal(zt.lshape_map, _lshape_map_1dev(zt.gshape, zt.split))
    np.testing.assert_allclose(zt.numpy(), zj.numpy(), rtol=1e-5, atol=1e-5)

    kmj = htj.cluster.KMeans(n_clusters=k, init=zj[:k], max_iter=10, tol=None).fit(zj)
    kmt = htt.cluster.KMeans(n_clusters=k, init=zt[:k], max_iter=10, tol=None).fit(zt)
    assert kmt.n_iter_ == kmj.n_iter_ == 10
    _same_meta(kmt.cluster_centers_, kmj.cluster_centers_)
    _same_meta(kmt.labels_, kmj.labels_)
    assert kmt.labels_.dtype is htt.int64
    np.testing.assert_array_equal(kmt.labels_.numpy(), kmj.labels_.numpy())
    np.testing.assert_allclose(kmt.cluster_centers_.numpy(), kmj.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kmt.inertia_, kmj.inertia_, rtol=1e-4)
    np.testing.assert_array_equal(kmt.labels_.lshape_map, _lshape_map_1dev((n,), 0))

    pj = kmj.predict((htj.array(new_np, split=0) - muj) / sdj)
    pt = kmt.predict((htt.array(new_np, split=0) - mut) / sdt)
    _same_meta(pt, pj)
    np.testing.assert_array_equal(pt.numpy(), pj.numpy())
    # the blobs are recovered: predicted labels are a relabelling of the truth
    assert len({(a, b) for a, b in zip(pt.numpy(), member_new)}) == k


def test_fit_with_tol_matches_heat_tpu(cpu):
    x_np, _ = _blobs(2, 150, 4, 4, scale=3.0)
    kmj = htj.cluster.KMeans(n_clusters=4, init=htj.array(x_np[:4]), max_iter=50, tol=1e-4).fit(htj.array(x_np, split=0))
    kmt = htt.cluster.KMeans(n_clusters=4, init=htt.array(x_np[:4]), max_iter=50, tol=1e-4).fit(htt.array(x_np, split=0))
    assert kmt.n_iter_ == kmj.n_iter_ < 50
    np.testing.assert_allclose(kmt.cluster_centers_.numpy(), kmj.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)


def test_kmeans_sampled_inits(cpu):
    x_np, _ = _blobs(3, 120, 3, 3)
    x = htt.array(x_np, split=0)
    for init in ("random", "probability_based"):
        a = htt.cluster.KMeans(n_clusters=3, init=init, random_state=7, max_iter=1, tol=None)
        c0 = a._initialize_cluster_centers(x).numpy()
        b = htt.cluster.KMeans(n_clusters=3, init=init, random_state=7)
        np.testing.assert_array_equal(b._initialize_cluster_centers(x).numpy(), c0)  # seeded: reproducible
        assert all(any(np.array_equal(c, r) for r in x_np) for c in c0)  # centroids are rows of x
        assert len({tuple(c) for c in c0}) == 3
        assert b.fit(x).cluster_centers_.shape == (3, 3)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=3, init="nope").fit(x)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=200).fit(x)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=3, init=htt.zeros((2, 3))).fit(x)
    with pytest.raises(TypeError):
        htt.cluster.KMeans(n_clusters=3).fit(x_np)
    with pytest.raises(RuntimeError):
        htt.cluster.KMeans(n_clusters=3).predict(x)


def test_kmeans_state_dict_round_trip(cpu):
    x_np, _ = _blobs(4, 90, 3, 3)
    x = htt.array(x_np, split=0)
    km = htt.cluster.KMeans(n_clusters=3, init=x[:3], max_iter=5, tol=None).fit(x)
    d = km.state_dict()
    assert set(d) >= {"n_clusters", "max_iter", "tol", "random_state", "n_iter", "inertia", "cluster_centers", "labels"}
    back = htt.cluster.KMeans().load_state_dict(d)
    np.testing.assert_array_equal(back.cluster_centers_.numpy(), km.cluster_centers_.numpy())
    np.testing.assert_array_equal(back.predict(x).numpy(), km.predict(x).numpy())
    assert back.labels_.split == 0 and back.n_iter_ == 5 and back.inertia_ == km.inertia_
    assert back.get_params()["n_clusters"] == 3


# ------------------------------------------------------------ statistics
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,axis", [((37,), None), ((37,), 0), ((40, 6), None), ((40, 6), 0), ((40, 6), 1), ((40, 6), -1)])
def test_moments_match_heat_tpu(cpu, shape, axis, dtype):
    rng = np.random.default_rng(len(shape) * 10 + (axis or 0))
    x_np = (rng.normal(size=shape) * 2.0 + 3.0).astype(dtype)
    xj, xt = htj.array(x_np, split=0), htt.array(x_np, split=0)
    for name, kw, rtol in [("mean", {}, 2e-6), ("var", {"ddof": 1}, 2e-4), ("std", {"ddof": 0}, 2e-4)]:
        rj = getattr(htj, name)(xj, axis=axis, **kw)
        rt = getattr(htt, name)(xt, axis=axis, **kw)
        _same_meta(rt, rj)
        np.testing.assert_allclose(rt.numpy(), rj.numpy(), rtol=rtol, atol=rtol)


def test_where_moments_match_heat_tpu(cpu):
    rng = np.random.default_rng(5)
    x_np = rng.normal(size=(30, 4)).astype(np.float32)
    mask = rng.random((30, 4)) > 0.3
    xj, xt = htj.array(x_np, split=0), htt.array(x_np, split=0)
    for axis in (None, 0, 1):
        np.testing.assert_allclose(
            htt.mean(xt, axis=axis, where=htt.array(mask)).numpy(),
            htj.mean(xj, axis=axis, where=htj.array(mask)).numpy(), rtol=2e-6, atol=2e-6,
        )
        np.testing.assert_allclose(
            htt.var(xt, axis=axis, ddof=1, where=mask).numpy(),
            htj.var(xj, axis=axis, ddof=1, where=mask).numpy(), rtol=2e-4, atol=2e-4,
        )


def test_integer_moments_decline_to_direct_reduction(cpu):
    x_np = np.arange(24, dtype=np.int32).reshape(6, 4)
    xt = htt.array(x_np, split=0)
    np.testing.assert_allclose(htt.mean(xt, axis=0).numpy(), x_np.mean(0), rtol=1e-6)
    np.testing.assert_allclose(htt.std(xt, ddof=1).numpy(), x_np.std(ddof=1), rtol=1e-6)


def test_memo_never_serves_stale_moments(cpu, monkeypatch):
    calls = []
    real = tstats.chunk_moments
    monkeypatch.setattr(tstats, "chunk_moments", lambda *a: calls.append(1) or real(*a))
    x_np = np.random.default_rng(6).normal(size=(50, 3)).astype(np.float32)
    x = htt.array(x_np, split=0)
    mu = htt.mean(x, axis=0).numpy()
    htt.std(x, axis=0)
    htt.var(x)  # axis=None comes from the same panel
    assert len(calls) == 1  # one read served all three
    x.larray.add_(1.0)  # in place: same tensor object, new _version
    np.testing.assert_allclose(htt.mean(x, axis=0).numpy(), mu + 1.0, rtol=1e-6)
    assert len(calls) == 2
    x += 1.0  # rebinds to a new tensor
    np.testing.assert_allclose(htt.mean(x, axis=0).numpy(), mu + 2.0, rtol=1e-6)
    assert len(calls) == 3


def test_inference_tensors_are_not_memoized(cpu):
    x_np = np.random.default_rng(7).normal(size=(20, 3)).astype(np.float32)
    with torch.inference_mode():
        x = htt.array(x_np)
        mu = htt.mean(x, axis=0).numpy()
        x.larray.add_(2.0)  # no version counter to see this: the memo must not be used
        np.testing.assert_allclose(htt.mean(x, axis=0).numpy(), mu + 2.0, rtol=1e-6)
        np.testing.assert_allclose(htt.std(x).numpy(), x_np.std(), rtol=2e-4)


def test_memo_counts_dispatches_and_stays_bounded(cpu):
    htt.kernels.reset_kernel_stats()
    x = htt.array(np.ones((8, 2), np.float32))
    htt.mean(x, axis=0)
    htt.std(x, axis=0)
    assert htt.KERNEL_STATS["moments_onepass.torch"] == 2 and htt.LAUNCHES["moments_onepass"] == 0
    keep = [htt.array(np.ones((4, 2), np.float32)) for _ in range(tstats._PANELS_CAP + 8)]
    for a in keep:
        htt.mean(a)
    assert len(tstats._PANELS) <= tstats._PANELS_CAP


# ------------------------------------------------------------------ cdist
@pytest.mark.parametrize("quadratic_expansion", [False, True])
def test_cdist_matches_heat_tpu(cpu, quadratic_expansion):
    rng = np.random.default_rng(8)
    a_np = rng.normal(size=(21, 4)).astype(np.float32)
    b_np = rng.normal(size=(9, 4)).astype(np.float32)
    for split_a in (0, None):
        rj = htj.spatial.cdist(htj.array(a_np, split=split_a), htj.array(b_np), quadratic_expansion=quadratic_expansion)
        rt = htt.spatial.cdist(htt.array(a_np, split=split_a), htt.array(b_np), quadratic_expansion=quadratic_expansion)
        _same_meta(rt, rj)
        np.testing.assert_allclose(rt.numpy(), rj.numpy(), rtol=1e-5, atol=2e-3 if quadratic_expansion else 1e-6)
    self_d = htt.spatial.cdist(htt.array(a_np), quadratic_expansion=quadratic_expansion).numpy()
    np.testing.assert_allclose(np.diag(self_d), 0.0, atol=2e-3)
    with pytest.raises(ValueError):
        htt.spatial.cdist(htt.array(a_np), htt.array(b_np[:, :3]))
    with pytest.raises(NotImplementedError):
        htt.spatial.cdist(htt.array(a_np, split=1), htt.array(b_np))


def test_cdist_exact_chunks_large_products(cpu, monkeypatch):
    from heat_tpu_torch.spatial import distance

    rng = np.random.default_rng(9)
    a, b = htt.array(rng.normal(size=(30, 3)).astype(np.float32)), htt.array(rng.normal(size=(50, 3)).astype(np.float32))
    whole = htt.spatial.cdist(a, b).numpy()
    monkeypatch.setattr(distance, "_EXACT_TEMP_ELEMS", 30 * 3 * 17)
    np.testing.assert_array_equal(htt.spatial.cdist(a, b).numpy(), whole)


# ------------------------------------------------- types, ops, factories
_TYPES = ["bool", "int32", "int64", "float32", "float64"]


@pytest.mark.parametrize("t1", _TYPES)
@pytest.mark.parametrize("t2", _TYPES)
def test_promotion_table_matches_heat_tpu(t1, t2):
    assert htt.promote_types(getattr(htt, t1), getattr(htt, t2)).__name__ == \
        htj.promote_types(getattr(htj, t1), getattr(htj, t2)).__name__


@pytest.mark.parametrize("op", ["__add__", "__sub__", "__mul__", "__truediv__", "__pow__", "__radd__", "__rsub__", "__rtruediv__"])
@pytest.mark.parametrize("dt,other", [("float32", 2.5), ("int32", 3), ("int32", 1.5), ("float64", 2), ("float32", "arr_i64")])
def test_binary_ops_match_heat_tpu(cpu, op, dt, other):
    base = np.array([[1, 2, 3], [4, 5, 6]], dtype=dt)
    if other == "arr_i64":
        oj, ot = htj.array(np.array([1, 2, 3], np.int64)), htt.array(np.array([1, 2, 3], np.int64))
    else:
        oj = ot = other
    rj = getattr(htj.array(base, split=0), op)(oj)
    rt = getattr(htt.array(base, split=0), op)(ot)
    _same_meta(rt, rj)
    np.testing.assert_allclose(rt.numpy(), rj.numpy(), rtol=1e-6)


def test_split_rules_match_heat_tpu(cpu):
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    for sa, sb, b in [(0, None, a[0]), (None, 0, a[:, :1]), (1, None, a), (None, None, a)]:
        rj = htj.array(a, split=sa) * htj.array(b, split=sb)
        rt = htt.array(a, split=sa) * htt.array(b, split=sb)
        _same_meta(rt, rj)
    with pytest.raises(ValueError):
        htt.array(a, split=0) + htt.array(a, split=1)
    with pytest.raises(ValueError):
        htt.array(a) + htt.array(a[:2])
    s = htt.array(a, split=0)
    np.testing.assert_array_equal((-s).numpy(), -a)
    r = htt.sum(s, axis=0)
    assert r.split is None and r.numpy().tolist() == a.sum(0).tolist()
    assert htt.sum(s, axis=1).split == 0 and htt.prod(s, axis=1, keepdims=True).split == 0
    assert htt.sum(htt.array(np.ones(3, np.int32))).dtype is htt.int64


@pytest.mark.parametrize("key", [1, -1, slice(1, 3), (slice(None), 2), (1, slice(0, 2)), (Ellipsis, 0), (slice(None, None, 2),)])
@pytest.mark.parametrize("split", [0, 1, None])
def test_getitem_matches_heat_tpu(cpu, key, split):
    a = np.arange(20, dtype=np.float32).reshape(5, 4)
    rj, rt = htj.array(a, split=split)[key], htt.array(a, split=split)[key]
    _same_meta(rt, rj)
    np.testing.assert_array_equal(rt.numpy(), rj.numpy())


def test_factories_match_heat_tpu(cpu):
    for name, args, kw in [
        ("zeros", ((3, 4),), {"split": 0}),
        ("ones", ((5,),), {"dtype": "int64"}),
        ("full", ((2, 3), 7.5), {"split": 1}),
        ("arange", (2, 11, 3), {}),
        ("arange", (0.5, 3.0, 0.5), {"split": 0}),
        ("array", ([[1.5, 2.0]],), {}),
        ("array", (np.arange(6, dtype=np.int64).reshape(2, 3),), {"split": 1}),
    ]:
        rj, rt = getattr(htj, name)(*args, **kw), getattr(htt, name)(*args, **kw)
        _same_meta(rt, rj)
        np.testing.assert_array_equal(rt.numpy(), rj.numpy())
    base_j, base_t = htj.ones((3, 2), split=0), htt.ones((3, 2), split=0)
    for name, args in [("zeros_like", ()), ("ones_like", ()), ("full_like", (4,))]:
        rj, rt = getattr(htj, name)(base_j, *args), getattr(htt, name)(base_t, *args)
        _same_meta(rt, rj)
        np.testing.assert_array_equal(rt.numpy(), rj.numpy())
    e = htt.empty_like(base_t, dtype=htt.int32)
    assert e.shape == (3, 2) and e.dtype is htt.int32 and e.split == 0
    c = htt.array(np.ones((2, 2), np.float32))
    assert c.astype(htt.float64).dtype is htt.float64 and c.item is not None and htt.array([3]).item() == 3


def test_random_is_seeded_and_shaped(cpu):
    htt.random.seed(11)
    a = htt.random.randn(6, 3, split=0)
    b = htt.random.rand(4)
    htt.random.seed(11)
    np.testing.assert_array_equal(htt.random.randn(6, 3, split=0).numpy(), a.numpy())
    assert a.split == 0 and a.dtype is htt.float32 and b.split is None
    assert ((b.numpy() >= 0) & (b.numpy() < 1)).all()
    r = htt.random.randint(2, 5, size=(50,), dtype=htt.int64)
    assert r.dtype is htt.int64 and set(np.unique(r.numpy())) <= {2, 3, 4}
    with pytest.raises(ValueError):
        htt.random.randint(5, 5)
    with pytest.raises(ValueError):
        htt.random.randn(3, dtype=htt.int32)


def test_communication_arithmetic_matches_heat_tpu():
    c1 = MeshCommunication(devices=[jax.devices()[0]])
    ct = htt.get_comm()
    assert ct.size == 1 and ct.rank == 0 and not ct.is_distributed()
    for shape, split in [((10, 3), 0), ((10, 3), 1), ((7,), 0), ((4, 5), None)]:
        assert ct.chunk(shape, split) == c1.chunk(shape, split, rank=0)
        np.testing.assert_array_equal(ct.lshape_map(shape, split), c1.lshape_map(shape, split))
        if split is not None:
            assert ct.counts_displs_shape(shape, split) == c1.counts_displs_shape(shape, split)
    with pytest.raises(NotImplementedError, match="multi-card"):
        htt.communication.TorchCommunication(size=2)
    with pytest.raises(TypeError):
        htt.use_comm("world")
    assert htt.sanitize_comm(None) is ct
