"""heat_tpu_torch's ML long tail against heat_tpu, on the CPU: the bundled
datasets, GaussianNB, Lasso and the entry module.

The same inputs (the bundled files, or numpy arrays made from a seed) go
through both packages; heat_tpu runs under ``comm_context(SELF)``, at world
size 1 as the port does here.

Tolerances:
- datasets: every array equal, dtype included;
- GaussianNB: classes, counts, priors and predictions exact; the means
  rtol 1e-5 (sums of 150 float32 rows in another order); the variances
  E[x²] − mean² atol 4e-5 (the float32 rounding of E[x²] of values up to
  ~10, 2^-24 * 100 * a few, cancelled against mean²); ``epsilon_`` rtol
  1e-5; posteriors atol 1e-5, log posteriors rtol 1e-5 (values to -1e4);
- Lasso: ``n_iter`` exact, θ atol 1e-5 (float32 coordinate descent on
  |θ| <= 4 in another summation order); one proximal-SGD step atol 1e-6;
- entry: the Lloyd step's centers rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
import heat_tpu.datasets  # noqa: F401 - heat_tpu does not import it on its own
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch import convert
from heat_tpu_torch.naive_bayes import gaussianNB as port_gnb

MEAN_RTOL = 1e-5
VAR_ATOL = 4e-5
PROBA_ATOL = 1e-5
LASSO_ATOL = 1e-5
SGD_ATOL = 1e-6


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _np(x):
    return np.asarray(x.numpy())


# ------------------------------------------------------------------ datasets
@pytest.mark.parametrize("loader", ["load_blobs", "load_classes", "load_regression"])
@pytest.mark.parametrize("split", [0, None])
def test_datasets_equal_heat_tpus(loader, split):
    def leaves(t):
        return [a for v in t for a in (leaves(v) if isinstance(v, tuple) else [v])]

    got, want = leaves(getattr(htt.datasets, loader)(split=split)), leaves(getattr(htj.datasets, loader)(split=split))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype.__name__ == w.dtype.__name__ and g.split == w.split and g.gshape == w.gshape
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_dataset_files_and_paths():
    for name in ("blobs.h5", "blobs.csv", "classes.h5", "regression.h5", "iris.csv"):
        with open(htt.datasets.dataset_path(name), "rb") as a, open(htj.datasets.dataset_path(name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(FileNotFoundError, match="heat_tpu_torch.datasets.generate"):
        htt.datasets.dataset_path("nope.h5")
    with pytest.raises(FileNotFoundError, match="cannot be regenerated"):
        htt.datasets.dataset_path("iris2.csv")


# ---------------------------------------------------------------- GaussianNB
def _classes(pkg):
    return pkg.datasets.load_classes()


def _same_nb(t, j):
    np.testing.assert_array_equal(t.classes_.numpy(), _np(j.classes_))
    np.testing.assert_array_equal(t.class_count_.numpy(), _np(j.class_count_))
    np.testing.assert_allclose(t.class_prior_.numpy(), _np(j.class_prior_), rtol=1e-6)
    np.testing.assert_allclose(t.theta_.numpy(), _np(j.theta_), rtol=MEAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(t.sigma_.numpy(), _np(j.sigma_), atol=VAR_ATOL)
    np.testing.assert_allclose(t.epsilon_, j.epsilon_, rtol=1e-5)
    for a in ("classes_", "class_count_", "theta_", "sigma_", "class_prior_"):
        assert getattr(t, a).dtype.__name__ == getattr(j, a).dtype.__name__, a


def _same_predictions(t, j, xt, xj):
    np.testing.assert_array_equal(t.predict(xt).numpy(), _np(j.predict(xj)))
    np.testing.assert_allclose(t.predict_proba(xt).numpy(), _np(j.predict_proba(xj)), atol=PROBA_ATOL)
    np.testing.assert_allclose(t.predict_log_proba(xt).numpy(), _np(j.predict_log_proba(xj)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [0, None])
def test_gaussian_nb_fit_and_predict(split):
    """The port at both splits against heat_tpu on replicated inputs (the values do not depend on the split)."""
    (tx, ty), (vx, vy) = htt.datasets.load_classes(split=split)
    (jx, jy), (jvx, jvy) = htj.datasets.load_classes(split=None)
    t, j = htt.naive_bayes.GaussianNB().fit(tx, ty), htj.naive_bayes.GaussianNB().fit(jx, jy)
    _same_nb(t, j)
    _same_predictions(t, j, vx, jvx)
    assert (t.predict(vx).numpy() == vy.numpy()).mean() > 0.9
    assert t.predict(vx).split == vx.split and t.predict_proba(vx).split == vx.split
    assert t.predict_proba(vx).gshape == (150, 3)
    a = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(t.logsumexp(htt.array(a), axis=1).numpy(), _np(j.logsumexp(htj.array(a), axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t.logsumexp(htt.array(a)).numpy()), np.log(np.exp(a.astype(np.float64)).sum()),
                               rtol=1e-6)  # all elements: the formula (heat_tpu's is the same jax call as axis=1's)


def test_gaussian_nb_partial_fit_weights_and_priors():
    (tx, ty), (vx, _) = htt.datasets.load_classes()
    (jx, jy), (jvx, _) = htj.datasets.load_classes(split=None)
    X, Y = tx.numpy(), ty.numpy()
    t, j = htt.naive_bayes.GaussianNB(), htj.naive_bayes.GaussianNB()
    for lo in (0, 150, 300):
        rows = slice(lo, lo + 150)
        t.partial_fit(htt.array(X[rows], split=0), htt.array(Y[rows], split=0), classes=np.array([0, 1, 2]))
        j.partial_fit(htj.array(X[rows]), htj.array(Y[rows]), classes=np.array([0, 1, 2]))
        _same_nb(t, j)
    _same_predictions(t, j, vx, jvx)
    w = np.random.default_rng(4).uniform(0.5, 2.0, size=450).astype(np.float32)
    pri = np.array([0.5, 0.3, 0.2])
    t = htt.naive_bayes.GaussianNB(priors=pri).fit(tx, ty, sample_weight=htt.array(w, split=0))
    j = htj.naive_bayes.GaussianNB(priors=pri).fit(jx, jy, sample_weight=htj.array(w))
    np.testing.assert_allclose(t.class_count_.numpy(), _np(j.class_count_), rtol=1e-6)
    np.testing.assert_allclose(t.theta_.numpy(), _np(j.theta_), rtol=MEAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(t.sigma_.numpy(), _np(j.sigma_), atol=VAR_ATOL)
    np.testing.assert_array_equal(t.class_prior_.numpy(), _np(j.class_prior_))
    _same_predictions(t, j, vx, jvx)


def test_gaussian_nb_errors_are_heat_tpus():
    x = np.random.default_rng(5).normal(size=(6, 2)).astype(np.float32)
    y = np.array([0, 1, 2, 0, 1, 5])
    msgs = []
    for pkg in (htt, htj):
        nb = pkg.naive_bayes.GaussianNB()
        with pytest.raises(ValueError) as e1:
            nb.partial_fit(pkg.array(x), pkg.array(y))
        with pytest.raises(ValueError) as e2:
            nb.partial_fit(pkg.array(x), pkg.array(y), classes=np.array([0, 1, 2]))
        with pytest.raises(TypeError):
            nb.fit(x, y)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="fit needs to be called"):
        htt.naive_bayes.GaussianNB().predict(htt.array(x))


def test_gaussian_nb_blocks_change_no_value(monkeypatch):
    """The joint log-likelihood in row blocks of 7 rows equals one block."""
    (tx, ty), (vx, _) = htt.datasets.load_classes()
    nb = htt.naive_bayes.GaussianNB().fit(tx, ty)
    whole = nb.predict_log_proba(vx).numpy()
    monkeypatch.setattr(port_gnb, "_BLOCK_ELEMS", 7 * 3 * 6)
    np.testing.assert_array_equal(nb.predict_log_proba(vx).numpy(), whole)


def test_gaussian_nb_from_heat_tpu_attributes():
    (jx, jy), (jvx, _) = htj.datasets.load_classes(split=None)
    (_, _), (vx, _) = htt.datasets.load_classes()
    j = htj.naive_bayes.GaussianNB().fit(jx, jy)
    attrs = {a: _np(getattr(j, a)) for a in ("classes_", "theta_", "sigma_", "class_prior_", "class_count_")}
    attrs["epsilon_"] = j.epsilon_
    t = convert.gaussian_nb_from_heat_tpu(attrs)
    np.testing.assert_array_equal(t.predict(vx).numpy(), _np(j.predict(jvx)))
    np.testing.assert_allclose(t.predict_proba(vx).numpy(), _np(j.predict_proba(jvx)), atol=PROBA_ATOL)


# --------------------------------------------------------------------- Lasso
def _regression(pkg, split=0):
    x, y, _ = htj.datasets.load_regression(split=None)
    X = np.asarray(x.numpy())
    X1 = np.concatenate([np.ones((X.shape[0], 1), np.float32), X], 1)
    return pkg.array(X1, split=split), pkg.array(np.asarray(y.numpy()), split=split), X1, np.asarray(y.numpy())


@pytest.mark.parametrize("lam", [0.1, 0.01, 0.001])
def test_lasso_fit_matches_heat_tpu(lam):
    xt, yt, X1, Y = _regression(htt)
    xj, yj, _, _ = _regression(htj)
    t = htt.regression.Lasso(lam=lam, max_iter=100).fit(xt, yt)
    j = htj.regression.Lasso(lam=lam, max_iter=100).fit(xj, yj)
    assert t.n_iter == j.n_iter
    np.testing.assert_allclose(t.theta.numpy(), _np(j.theta), atol=LASSO_ATOL)
    assert t.theta.gshape == (13, 1) and t.theta.split is None
    np.testing.assert_allclose(t.coef_.numpy(), _np(j.coef_), atol=LASSO_ATOL)
    np.testing.assert_allclose(t.intercept_.numpy().ravel(), _np(j.intercept_).ravel(), atol=LASSO_ATOL)
    pt, pj = t.predict(xt), j.predict(xj)
    assert pt.gshape == pj.gshape and pt.split == pj.split
    np.testing.assert_allclose(pt.numpy(), _np(pj), atol=1e-4)
    assert abs(t.rmse(yt, pt.T.reshape((400,))) - j.rmse(yj, pj.T.reshape((400,)))) < 1e-5


def test_lasso_max_iter_and_the_intercept_is_not_regularized():
    xt, yt, _, _ = _regression(htt)
    xj, yj, _, _ = _regression(htj)
    t = htt.regression.Lasso(lam=10.0, max_iter=3, tol=0.0).fit(xt, yt)
    j = htj.regression.Lasso(lam=10.0, max_iter=3, tol=0.0).fit(xj, yj)
    assert t.n_iter == j.n_iter == 3
    np.testing.assert_allclose(t.theta.numpy(), _np(j.theta), atol=LASSO_ATOL)
    assert np.all(t.theta.numpy()[1:] == 0) and t.theta.numpy()[0, 0] != 0  # every slope thresholded away


def test_lasso_partial_fit_steps():
    xt, yt, X1, Y = _regression(htt)
    t, j = htt.regression.Lasso(lam=0.01), htj.regression.Lasso(lam=0.01)
    for i in range(5):
        rows = slice(i * 80, (i + 1) * 80)
        t.partial_fit(htt.array(X1[rows], split=0), htt.array(Y[rows], split=0), lr=0.1)
        j.partial_fit(htj.array(X1[rows], split=0), htj.array(Y[rows], split=0), lr=0.1)
        np.testing.assert_allclose(t.theta.numpy(), _np(j.theta), atol=SGD_ATOL)
    assert t.n_iter == j.n_iter == 5


def test_lasso_state_soft_threshold_and_supervisor():
    xt, yt, _, _ = _regression(htt)
    xj, yj, _, _ = _regression(htj)
    j = htj.regression.Lasso(lam=0.01).fit(xj, yj)
    t = convert.lasso_from_heat_tpu(j.state_dict())
    assert t.n_iter == j.n_iter and t.lam == j.lam
    np.testing.assert_array_equal(t.theta.numpy(), _np(j.theta))
    back = htj.regression.Lasso().load_state_dict(t.state_dict())
    np.testing.assert_array_equal(_np(back.theta), t.theta.numpy())
    rho = np.linspace(-1, 1, 9).astype(np.float32)
    np.testing.assert_array_equal(t.soft_threshold(htt.array(rho)).numpy(), _np(j.soft_threshold(htj.array(rho))))
    # heat_tpu's soft_threshold of a plain array raises (UnboundLocalError, heat_tpu/regression/lasso.py:174):
    # the port's is held to the formula
    want = np.sign(rho) * np.maximum(np.abs(rho) - t.lam, 0.0)
    np.testing.assert_allclose(t.soft_threshold(torch.tensor(rho)).numpy(), want, rtol=1e-6)
    # the supervised fit (blocks of 4 sweeps, the residual rebuilt at each block) ends where heat_tpu's plain fit does
    s = htt.regression.Lasso(lam=0.01).fit(xt, yt, supervisor=htt.resilience.Supervisor(), block_iters=4)
    assert s.n_iter == j.n_iter and not s.supervisor_result_.detached
    np.testing.assert_allclose(s.theta.numpy(), _np(j.theta), atol=LASSO_ATOL)
    with pytest.raises(RuntimeError, match="fit needs to be called"):
        htt.regression.Lasso().predict(xt)


# -------------------------------------------------------------------- entry
def test_entry_step_matches_heat_tpus():
    import __graft_entry__ as graft
    import jax.numpy as jnp

    from heat_tpu_torch import entry

    fn, args = entry.entry("cpu")
    jfn, jargs = graft.entry()
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(jfn(*jargs)), rtol=1e-6)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1000, 32)).astype(np.float32)
    c = x[:8].copy()
    htt.kernels.reset_kernel_stats()
    got = fn(torch.tensor(x), torch.tensor(c))
    assert htt.KERNEL_STATS.get("lloyd_fused.torch") == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(x), jnp.asarray(c))), rtol=1e-5, atol=1e-6)
