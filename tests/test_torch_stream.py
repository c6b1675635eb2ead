"""heat_tpu_torch's stream path against heat_tpu's, on the CPU:
``ChunkIterator`` (array and file sources), ``Prefetcher``, the streaming
estimators and ``StreamingKMeans``.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does. The port's chunks take the kernels' plain versions here
(``chunk_moments`` for ``moments_onepass``, ``assign_stats`` for
``lloyd_fused``); ``KERNEL_STATS`` shows one route decision per chunk.

Tolerances: chunk values, histogram counts and geometry exact. Streamed
means, variances and covariances rtol 1e-5 / atol 1e-6 against heat_tpu's
and against the in-memory results: float32 sums over at most a few
thousand rows of values of order 1, re-associated (per chunk, and by the
Chan merge), differ by a few ulp. Histogram edges within one float32
ulp (rtol 2.4e-7): XLA's rounding of ``jnp.linspace`` differs from the
formula's in the last bit. StreamingKMeans centres rtol 1e-5 /
atol 1e-5 on well-separated blobs (labels equal, so the centres are
means of the same rows summed in another order).
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL, ATOL = 1e-5, 1e-6
KM_RTOL, KM_ATOL = 1e-5, 1e-5
_rng = np.random.default_rng(2027)
X = (_rng.normal(size=(1000, 6)) * np.array([1, 2, 0.5, 4, 1, 3]) + 1.5).astype(np.float32)
CHUNK = 128  # 7 full chunks and a tail of 104 rows


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    centres = (rng.normal(size=(k, f)) * 12).astype(np.float32)
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    return (centres[member] + rng.normal(size=(n, f))).astype(np.float32), member


BLOBS, MEMBER = _blobs(2000, 5, 4, 3)


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _close(t, j, rtol=RTOL, atol=ATOL):
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=rtol, atol=atol)


def _write(tmp_path, fmt, a):
    """``a`` in a file of ``fmt`` written by the port: (path, dataset)."""
    if fmt == "csv":
        path = str(tmp_path / "s.csv")
        htt.save(htt.array(a), path)
        return path, None
    path = str(tmp_path / ("s.h5" if fmt == "hdf5" else "s.nc"))
    kwargs = {"cdf2": {"format": "NETCDF3_64BIT"}, "cdf1": {"format": "NETCDF3_CLASSIC"}}.get(fmt, {})
    htt.save(htt.array(a), path, "x", **kwargs)
    return path, "x"


# ----------------------------------------------------------- ChunkIterator
@pytest.mark.parametrize("source", ["array", "dndarray", "hdf5", "cdf1", "cdf2", "csv"])
@pytest.mark.parametrize("split", [0, 1, None])
def test_chunk_iterator_matches_heat_tpus_chunks(tmp_path, source, split):
    kw = {}
    if source in ("array", "dndarray"):
        src_t = htt.array(X, split=0) if source == "dndarray" else X
        src_j = htj.array(X, split=0) if source == "dndarray" else X
    else:
        src_t, dataset = _write(tmp_path, source, X)
        src_j = src_t
        kw = {"dataset": dataset} if dataset else {}
    it_t = htt.stream.ChunkIterator(src_t, CHUNK, split=split, **kw)
    it_j = htj.stream.ChunkIterator(src_j, CHUNK, split=split, **kw)
    assert len(it_t) == len(it_j) == 8 and it_t.n_rows == it_j.n_rows == 1000
    for _ in range(2):  # re-iterable: the second pass starts at row 0 again
        chunks_t, chunks_j = list(it_t), list(it_j)
        assert [c.gshape for c in chunks_t] == [c.gshape for c in chunks_j] == [(128, 6)] * 7 + [(104, 6)]
        for t, j in zip(chunks_t, chunks_j):
            assert t.split == j.split and t.dtype.__name__ == j.dtype.__name__
            np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    for a, b in zip(it_t.iter_raw(), it_j.iter_raw()):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


def test_chunk_iterator_counts_chunks_and_bytes_and_refuses_bad_sources(tmp_path):
    htt.stream.reset_stream_stats()
    list(htt.stream.ChunkIterator(X, 300, dtype=htt.float64))
    assert htt.STREAM_STATS["chunks"] == 4 and htt.STREAM_STATS["bytes_read"] == X.size * 8
    for pkg in (htt, htj):
        with pytest.raises(FileNotFoundError):
            pkg.stream.ChunkIterator(str(tmp_path / "none.h5"), 4, dataset="x")
        with pytest.raises(ValueError):
            pkg.stream.ChunkIterator(X, 0)
        path, _ = _write(tmp_path, "hdf5", X)
        with pytest.raises(ValueError):
            pkg.stream.ChunkIterator(path, 4)  # no dataset


# ------------------------------------------------------------- Prefetcher
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_prefetcher_yields_the_same_sequence(tmp_path, depth):
    path, dataset = _write(tmp_path, "cdf2", X)
    it = htt.stream.ChunkIterator(path, CHUNK, dataset=dataset)
    plain = [c.numpy() for c in it]
    htt.stream.reset_stream_stats()
    with htt.stream.Prefetcher(it, depth=depth) as pf:
        got = [c.numpy() for c in pf]
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    s = htt.STREAM_STATS
    assert s["chunks"] == 8
    if depth > 0:  # every chunk's fetch is a hit or a stall; the fetch that finds the end may stall too
        assert s["prefetch_hits"] <= 8 and 8 <= s["prefetch_hits"] + s["stalls"] <= 9
    # a generic iterable of staged chunks goes through unchanged
    staged = list(htt.stream.Prefetcher(list(it), depth=depth))
    assert [c.gshape for c in staged] == [c.gshape for c in it]


def test_prefetcher_reraises_the_readers_exception_and_closes_early():
    def bad():
        yield htt.array(X[:4])
        raise OSError("disk gone")

    pf = htt.stream.Prefetcher(bad(), depth=2)
    assert next(pf).gshape == (4, 6)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf = htt.stream.Prefetcher(htt.stream.ChunkIterator(X, 10), depth=3)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


# ------------------------------------------------------------- estimators
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [0, None])
def test_streaming_moments_match_heat_tpu_and_the_in_memory_moments(dtype, split):
    a = X.astype(dtype)
    htt.kernels.reset_kernel_stats()
    t = htt.stream.StreamingMoments(ddof=1)
    for c in htt.stream.ChunkIterator(a, CHUNK, split=split, dtype=getattr(htt, dtype)):
        t.update(c)
    j = htj.stream.StreamingMoments(ddof=1)
    for c in htj.stream.ChunkIterator(a, CHUNK, split=split, dtype=getattr(htj, dtype)):
        j.update(c)
    route = "moments_onepass.torch"  # float32 takes the kernel's route (its plain version here), float64 the plain one
    assert htt.KERNEL_STATS.get(route) == 8, htt.KERNEL_STATS
    assert t.n == j.n == 1000
    for name in ("mean", "var", "std"):
        _close(getattr(t, name), getattr(j, name))
    whole = htt.array(a, split=0)
    _close(t.mean, htj.array(np.asarray(htt.mean(whole, axis=0).numpy())))
    np.testing.assert_allclose(t.var.numpy(), htt.var(whole, axis=0, ddof=1).numpy(), rtol=RTOL, atol=ATOL)


def test_streaming_moments_merge_equals_one_pass():
    one, a, b = (htt.stream.StreamingMoments() for _ in range(3))
    for c in htt.stream.ChunkIterator(X, CHUNK):
        one.update(c)
    for c in htt.stream.ChunkIterator(X[:384], CHUNK):
        a.update(c)
    for c in htt.stream.ChunkIterator(X[384:], CHUNK):
        b.update(c)
    a.merge(b)
    np.testing.assert_allclose(a.mean.numpy(), one.mean.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.var.numpy(), one.var.numpy(), rtol=RTOL, atol=ATOL)
    assert a.merge_processes() is a  # world size 1: nothing to merge


@pytest.mark.parametrize("bias", [False, True])
def test_streaming_cov_matches_heat_tpu_and_cov(bias):
    t, j = htt.stream.StreamingCov(bias=bias), htj.stream.StreamingCov(bias=bias)
    for c in htt.stream.ChunkIterator(X, CHUNK):
        t.update(c)
    for c in htj.stream.ChunkIterator(X, CHUNK):
        j.update(c)
    _close(t.cov, j.cov, rtol=1e-5, atol=1e-5)
    _close(t.mean, j.mean)
    np.testing.assert_allclose(t.cov.numpy(), np.cov(X.astype(np.float64), rowvar=False, bias=bias), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bins,rng", [(10, (-5.0, 10.0)), (7, (0.0, 3.0))])
def test_streaming_histogram_counts_equal_heat_tpus(bins, rng):
    t, j = htt.stream.StreamingHistogram(bins, rng), htj.stream.StreamingHistogram(bins, rng)
    for c in htt.stream.ChunkIterator(X, CHUNK):
        t.update(c)
    for c in htj.stream.ChunkIterator(X, CHUNK):
        j.update(c)
    assert t.hist.dtype.__name__ == j.hist.dtype.__name__ == "int32"
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist.numpy()))
    # XLA rounds jnp.linspace's float32 edges its own way: one ulp apart at most
    np.testing.assert_allclose(t.bin_edges.numpy(), np.asarray(j.bin_edges.numpy()), rtol=2.4e-7, atol=0)
    counts, _ = htt.histogram(htt.array(X), bins=bins, range=rng)
    np.testing.assert_array_equal(t.hist.numpy(), counts.numpy())
    with pytest.raises(ValueError):
        htt.stream.StreamingHistogram(4)


# ---------------------------------------------------------- StreamingKMeans
def _fit(pkg, algorithm, max_iter, prefetch=None, split=0):
    init = pkg.array(BLOBS[:4])
    km = pkg.cluster.StreamingKMeans(4, init=init, max_iter=max_iter, tol=None, algorithm=algorithm)
    return km.fit(pkg.stream.ChunkIterator(BLOBS, 256, split=split), prefetch_depth=prefetch)


@pytest.mark.parametrize("prefetch", [None, 2])
def test_streaming_kmeans_global_matches_heat_tpu_and_kmeans(prefetch):
    htt.kernels.reset_kernel_stats()
    t = _fit(htt, "global", 5, prefetch)
    assert htt.KERNEL_STATS.get("lloyd_fused.torch") == 5 * 8
    j = _fit(htj, "global", 5, prefetch)
    _close(t.cluster_centers_, j.cluster_centers_, KM_RTOL, KM_ATOL)
    assert t.n_iter_ == j.n_iter_ == 5 and t.labels_ is None
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=1e-5)
    km = htt.cluster.KMeans(4, init=htt.array(BLOBS[:4]), max_iter=5, tol=None).fit(htt.array(BLOBS, split=0))
    np.testing.assert_allclose(t.cluster_centers_.numpy(), km.cluster_centers_.numpy(), rtol=KM_RTOL, atol=KM_ATOL)
    np.testing.assert_array_equal(t.predict(htt.array(BLOBS)).numpy(), km.labels_.numpy())


def test_streaming_kmeans_minibatch_and_partial_fit_match_heat_tpu():
    t, j = _fit(htt, "minibatch", 2), _fit(htj, "minibatch", 2)
    _close(t.cluster_centers_, j.cluster_centers_, KM_RTOL, KM_ATOL)
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=1e-5)
    pt = htt.cluster.StreamingKMeans(4, init=htt.array(BLOBS[:4]))
    pj = htj.cluster.StreamingKMeans(4, init=htj.array(BLOBS[:4]))
    for start in range(0, 2000, 700):
        pt.partial_fit(htt.array(BLOBS[start:start + 700], split=0))
        pj.partial_fit(htj.array(BLOBS[start:start + 700], split=0))
        _close(pt.cluster_centers_, pj.cluster_centers_, KM_RTOL, KM_ATOL)
    assert pt.n_iter_ == pj.n_iter_ == 3
    acc = (pt.predict(htt.array(BLOBS)).numpy() == pj.predict(htj.array(BLOBS)).numpy()).mean()
    assert acc == 1.0


def test_streaming_kmeans_random_init_and_errors():
    km = htt.cluster.StreamingKMeans(4, init="random", random_state=5, max_iter=3).fit(
        htt.stream.ChunkIterator(BLOBS, 500))
    assert km.cluster_centers_.shape == (4, 5) and 1 <= km.n_iter_ <= 3
    with pytest.raises(ValueError):
        htt.cluster.StreamingKMeans(algorithm="online")
    with pytest.raises(ValueError, match="re-iterable"):
        htt.cluster.StreamingKMeans(4, init=htt.array(BLOBS[:4]), max_iter=2, tol=None).fit(
            htt.stream.Prefetcher(htt.stream.ChunkIterator(BLOBS, 500)))
