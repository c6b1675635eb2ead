"""heat_tpu_torch's ``graph.Laplacian`` and ``cluster.Spectral`` against
heat_tpu's, on the CPU.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)`` (world size 1, as the port runs here). The
distributed forms run in the 4-rank gloo session of
``tests/test_torch_dist.py`` (its ``spectral`` case).

Tolerances: a Laplacian's entries within 1e-5 of heat_tpu's (its
similarities are float32 rbf values in [0, 1] from the same quadratic
expansion, rounded by another library's exp, and the degrees are float32
sums of up to n = 120 of them in another order: n·eps·max|d| ≈ 1e-5 of the
``simple`` diagonal, and ``norm_sym``'s entries are at most 1). Ritz values
within 1e-4 (float32 Lanczos on an operator of norm <= 2). The spectral
embedding is compared up to the sign of each column, within 1e-3 (its
columns are eigenvectors of eigenvalues 1e-2 apart, so float32 noise of
1e-6 moves them by ~1e-4). Labels exactly: the blobs are far apart, and
KMeans' distances do not depend on a column's sign.
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

LAP_ATOL, RITZ_ATOL, EMBED_ATOL = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _blobs(n=120, f=3, k=3, seed=90, spread=1.0):
    """k blobs with centres on a circle of radius 8 in the first two
    features: every pair of centres at least 13.8 apart."""
    rng = np.random.default_rng(seed)
    angles = 2 * np.pi * np.arange(k) / k
    centres = np.zeros((k, f))
    centres[:, 0], centres[:, 1] = 8 * np.cos(angles), 8 * np.sin(angles)
    member = np.arange(n) % k
    return (centres[member] + spread * rng.normal(size=(n, f))).astype(np.float32), member


def _meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)


@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
@pytest.mark.parametrize("mode", ["fully_connected", "eNeighbour"])
@pytest.mark.parametrize("key", ["upper", "lower"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("split", [None, 0])
def test_laplacian_matches_heat_tpu(definition, mode, key, weighted, split):
    x, _ = _blobs()
    kw = dict(definition=definition, mode=mode, threshold_key=key, threshold_value=0.3, weighted=weighted)
    Lt = htt.graph.Laplacian(lambda z: htt.spatial.rbf(z, sigma=3.0), **kw).construct(htt.array(x, split=split))
    Lj = htj.graph.Laplacian(lambda z: htj.spatial.rbf(z, sigma=3.0), **kw).construct(htj.array(x, split=split))
    _meta(Lt, Lj)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj.numpy()), rtol=0, atol=LAP_ATOL * max(1.0, np.abs(Lj.numpy()).max()))


def test_laplacian_of_a_distance_metric_and_checks():
    x, _ = _blobs(n=30)
    Lt = htt.graph.Laplacian(lambda z: htt.spatial.cdist(z), definition="simple").construct(htt.array(x, split=0))
    Lj = htj.graph.Laplacian(lambda z: htj.spatial.cdist(z), definition="simple").construct(htj.array(x, split=0))
    _meta(Lt, Lj)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj.numpy()), rtol=1e-5, atol=1e-4)
    for pkg in (htt, htj):
        with pytest.raises(NotImplementedError):
            pkg.graph.Laplacian(lambda z: z, definition="norm_rw")
        with pytest.raises(NotImplementedError):
            pkg.graph.Laplacian(lambda z: z, mode="kNN")
        with pytest.raises(TypeError):
            pkg.graph.Laplacian(lambda z: z.numpy()).construct(pkg.array(x))


def _signed_columns(v):
    s = np.sign(v[np.abs(v).argmax(axis=0), np.arange(v.shape[1])])
    return v * s[None, :]


@pytest.mark.parametrize("split", [None, 0])
def test_spectral_embedding_matches_heat_tpu_up_to_sign(split):
    """Blobs at unequal distances (9, 15, 17.5), close enough that the
    second and third eigenvalues sit more than 1e-2 above 0 and apart:
    each embedding column is defined up to its sign."""
    centres = np.array([[0.0, 0.0, 0.0], [9.0, 0.0, 0.0], [0.0, 15.0, 0.0]])
    x = (centres[np.arange(120) % 3] + 2.0 * np.random.default_rng(90).normal(size=(120, 3))).astype(np.float32)
    kw = dict(n_clusters=3, gamma=0.02, n_lanczos=40)
    evt, Vt, et = htt.cluster.Spectral(**kw)._spectral_embedding(htt.array(x, split=split))
    evj, fullj = htj.cluster.Spectral(**kw)._spectral_embedding(htj.array(x, split=split))
    evj = np.asarray(evj.numpy())
    np.testing.assert_allclose(evt.numpy(), evj, rtol=0, atol=RITZ_ATOL)
    assert np.diff(evj[:4]).min() > 1e-2
    emb_t = (Vt @ et[:, :3]).numpy()
    np.testing.assert_allclose(_signed_columns(emb_t), _signed_columns(np.asarray(fullj.numpy())[:, :3]), rtol=0,
                               atol=EMBED_ATOL)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("metric", ["rbf", "euclidean"])
def test_spectral_fit_predict_labels_equal_heat_tpus(split, metric):
    x, member = _blobs()
    gamma = 0.05 if metric == "rbf" else 1.0
    kw = dict(n_clusters=3, gamma=gamma, metric=metric, n_lanczos=30, random_state=4)
    st = htt.cluster.Spectral(**kw).fit(htt.array(x, split=split))
    sj = htj.cluster.Spectral(**kw).fit(htj.array(x, split=split))
    _meta(st.labels_, sj.labels_)
    np.testing.assert_array_equal(st.labels_.numpy(), sj.labels_.numpy())
    pt, pj = st.predict(htt.array(x, split=split)), sj.predict(htj.array(x, split=split))
    _meta(pt, pj)
    np.testing.assert_array_equal(pt.numpy(), pj.numpy())
    if metric == "rbf":  # the rbf graph separates the blobs: one label per blob
        lab = st.labels_.numpy()
        assert all(len(set(lab[member == c])) == 1 for c in range(3)) and len(set(lab)) == 3


def test_spectral_eigengap_and_parameters_match_heat_tpu():
    x, _ = _blobs()
    st = htt.cluster.Spectral(gamma=0.05, n_lanczos=30, random_state=4).fit(htt.array(x, split=0))
    sj = htj.cluster.Spectral(gamma=0.05, n_lanczos=30, random_state=4).fit(htj.array(x, split=0))
    assert st.n_clusters == sj.n_clusters == 3 and st._cluster.n_clusters == 3
    np.testing.assert_array_equal(st.labels_.numpy(), sj.labels_.numpy())
    assert st.get_params() == sj.get_params()
    for pkg in (htt, htj):
        with pytest.raises(NotImplementedError):
            pkg.cluster.Spectral(metric="cosine")
        with pytest.raises(NotImplementedError):
            pkg.cluster.Spectral(assign_labels="discretize")
        with pytest.raises(RuntimeError):
            pkg.cluster.Spectral(n_clusters=2).predict(pkg.array(x))
        with pytest.raises(TypeError):
            pkg.cluster.Spectral(n_clusters=2).fit(x)


def test_fitted_spectral_carries_over_from_heat_tpu():
    """A port Spectral built from heat_tpu's parameters and KMeans state
    predicts heat_tpu's labels on new data of the same blobs."""
    x, _ = _blobs()
    x_new, _ = _blobs(n=60, seed=91)
    sj = htj.cluster.Spectral(n_clusters=3, gamma=0.05, n_lanczos=30, random_state=4).fit(htj.array(x, split=0))
    st = htt.convert.spectral_from_heat_tpu(sj.get_params(), sj._cluster.state_dict())
    np.testing.assert_array_equal(st.labels_.numpy(), sj.labels_.numpy())
    np.testing.assert_array_equal(st.predict(htt.array(x_new, split=0)).numpy(), sj.predict(htj.array(x_new, split=0)).numpy())
    with pytest.raises(KeyError):
        htt.convert.spectral_from_heat_tpu({"bandwidth": 1.0}, sj._cluster.state_dict())
