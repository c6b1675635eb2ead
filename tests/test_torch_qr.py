"""heat_tpu_torch's ``linalg.qr`` against heat_tpu's, on the CPU.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)`` (world size 1, as the port runs). Tolerances:

- on the CholeskyQR2 route, R within 1e-4 of heat_tpu's, relative to
  max |R| (two float32 Gram passes in another summation order);
- on both routes ||QR - A||max / ||A||max <= 1e-5 and ||QᵀQ - I||max <= 1e-4,
  computed in float64 from the float32 factors;
- on the Householder route R is compared with heat_tpu's after each row is
  multiplied by the sign of its diagonal entry, within the same 1e-4.

Values, dtype, ``gshape``, ``split`` and ``lshape_map`` are compared; each
case also checks which route the port counted and, through heat_tpu's own
CholeskyQR2 core, that heat_tpu's guard decided the same.
"""
import warnings

import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context
from heat_tpu.core.linalg.qr import _cholqr2_core

import heat_tpu_torch as htt

R_RTOL = 1e-4
RESID_RTOL = 1e-5
ORTHO_ATOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_self():
    """The port on the CPU, heat_tpu on a 1-device communicator."""
    htt.use_device("cpu")
    htt.kernels.reset_kernel_stats()
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _tall(m=4096, n=64, seed=0):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


def _ill_conditioned(m=4096, n=64, seed=5):
    """Singular values logspace(0, -6) between random singular vectors:
    cond(A) = 1e6 > eps^-1/2, which CholeskyQR2 cannot orthogonalize in
    float32. (Columns merely scaled by logspace(0, -6) do not trip the
    guard: a Cholesky factorization is unaffected by diagonal scaling.)"""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(m, n)))[0]
    v = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return ((u * np.logspace(0, -6, n)) @ v.T).astype(np.float32)


def _heat_tpu_guard_trips(a):
    import jax

    with jax.default_matmul_precision("highest"):
        return bool(_cholqr2_core(jax.numpy.asarray(a, jax.numpy.float32))[2])


def _meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)


def _check_factors(q, r, a):
    q64, r64, a64 = q.numpy().astype(np.float64), r.numpy().astype(np.float64), a.astype(np.float64)
    assert np.abs(q64 @ r64 - a64).max() <= RESID_RTOL * np.abs(a64).max()
    assert np.abs(q64.T @ q64 - np.eye(q64.shape[1])).max() <= ORTHO_ATOL
    assert (np.tril(r.numpy(), -1) == 0).all()


def _sign_normalized(r):
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    return r * s[:, None]


def _routes():
    return {k: v for k, v in htt.KERNEL_STATS.items() if k.startswith("qr.")}


@pytest.mark.parametrize("split", [None, 0, 1])
def test_cholqr2_route_matches_heat_tpu(split):
    a = _tall()
    assert not _heat_tpu_guard_trips(a)
    qt, rt = htt.linalg.qr(htt.array(a, split=split))
    qj, rj = htj.linalg.qr(htj.array(a, split=split))
    assert _routes() == {"qr.cholqr2": 1}
    _meta(qt, qj)
    _meta(rt, rj)
    assert qt.split == split and rt.split == (None if split == 0 else split)
    rjn = np.asarray(rj.numpy())
    np.testing.assert_allclose(rt.numpy(), rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
    _check_factors(qt, rt, a)


@pytest.mark.parametrize("conditioning", ["scaled_columns", "ill_conditioned"])
def test_guard_decides_as_heat_tpu(conditioning):
    """Columns scaled by logspace(0, -6) keep CholeskyQR2; singular values
    logspace(0, -6) between random singular vectors defeat it in float32,
    and both packages fall back to Householder."""
    if conditioning == "scaled_columns":
        a = (_tall() * np.logspace(0, -6, 64)).astype(np.float32)
        assert not _heat_tpu_guard_trips(a)
        qt, rt = htt.linalg.qr(htt.array(a, split=0))
        assert _routes() == {"qr.cholqr2": 1}
        rjn = np.asarray(htj.linalg.qr(htj.array(a, split=0)).R.numpy())
        np.testing.assert_allclose(rt.numpy(), rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
        _check_factors(qt, rt, a)
        return
    a = _ill_conditioned()
    assert _heat_tpu_guard_trips(a)
    qt, rt = htt.linalg.qr(htt.array(a, split=0))
    qj, rj = htj.linalg.qr(htj.array(a, split=0))
    assert _routes() == {"qr.householder": 1}
    _meta(qt, qj)
    _meta(rt, rj)
    rjn = _sign_normalized(np.asarray(rj.numpy()))
    np.testing.assert_allclose(_sign_normalized(rt.numpy()), rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
    _check_factors(qt, rt, a)


@pytest.mark.parametrize("method,route", [("auto", "cholqr2"), ("cholqr2", "cholqr2"), ("householder", "householder")])
@pytest.mark.parametrize("shape", [(4096, 64), (100, 64)])
def test_methods(method, route, shape):
    """``auto`` takes CholeskyQR2 only for m >= 4n; ``cholqr2`` for any
    m >= n; ``householder`` always."""
    if shape == (100, 64) and method == "auto":
        route = "householder"
    a = _tall(*shape, seed=1)
    qt, rt = htt.linalg.qr(htt.array(a), method=method)
    qj, rj = htj.linalg.qr(htj.array(a), method=method)
    assert _routes() == {f"qr.{route}": 1}
    _meta(qt, qj)
    _meta(rt, rj)
    rtn, rjn = rt.numpy(), np.asarray(rj.numpy())
    if route == "householder":
        rtn, rjn = _sign_normalized(rtn), _sign_normalized(rjn)
    np.testing.assert_allclose(rtn, rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
    _check_factors(qt, rt, a)


@pytest.mark.parametrize("method", ["auto", "cholqr2"])
def test_wide_input_takes_householder(method):
    a = _tall(40, 100, seed=2)
    qt, rt = htt.linalg.qr(htt.array(a, split=1), method=method)
    qj, rj = htj.linalg.qr(htj.array(a, split=1), method=method)
    assert _routes() == {"qr.householder": 1}
    assert qt.shape == (40, 40) and rt.shape == (40, 100)
    _meta(qt, qj)
    _meta(rt, rj)
    rjn = _sign_normalized(np.asarray(rj.numpy()))
    np.testing.assert_allclose(_sign_normalized(rt.numpy()), rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
    _check_factors(qt, rt, a)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_input_types(dtype):
    """Integer input computes in float32 (int64 too, as jnp promotes it);
    float64 stays float64."""
    a = np.random.default_rng(3).integers(-9, 10, size=(512, 16)).astype(dtype)
    qt, rt = htt.linalg.qr(htt.array(a, split=0))
    qj, rj = htj.linalg.qr(htj.array(a, split=0))
    _meta(qt, qj)
    _meta(rt, rj)
    assert rt.dtype is (htt.float64 if dtype == np.float64 else htt.float32)
    rjn = np.asarray(rj.numpy())
    np.testing.assert_allclose(rt.numpy(), rjn, rtol=0, atol=R_RTOL * np.abs(rjn).max())
    _check_factors(qt, rt, a.astype(np.float64))


@pytest.mark.parametrize("a_case", ["cholqr2", "householder"])
def test_calc_q_false(a_case):
    a = _tall() if a_case == "cholqr2" else _ill_conditioned()
    qt, rt = htt.linalg.qr(htt.array(a, split=0), calc_q=False)
    qj, rj = htj.linalg.qr(htj.array(a, split=0), calc_q=False)
    assert qt is None and qj is None
    assert _routes() == {f"qr.{a_case}": 1}
    _meta(rt, rj)
    rfull = htt.linalg.qr(htt.array(a, split=0)).R.numpy()
    np.testing.assert_allclose(rt.numpy(), rfull, rtol=0, atol=R_RTOL * np.abs(rfull).max())


def test_result_is_a_namedtuple():
    res = htt.linalg.qr(htt.array(_tall(256, 8)))
    assert type(res).__name__ == "QR" and res._fields == ("Q", "R")
    q, r = res
    assert q is res.Q and r is res.R


@pytest.mark.parametrize(
    "args,kwargs,err",
    [
        (("not an array",), {}, TypeError),
        (("1d",), {}, ValueError),
        (("3d",), {}, ValueError),
        (("ok",), {"method": "gram"}, ValueError),
        (("ok",), {"tiles_per_proc": 1.5}, TypeError),
        (("ok",), {"tiles_per_proc": True}, TypeError),
        (("ok",), {"tiles_per_proc": "2"}, TypeError),
        (("ok",), {"tiles_per_proc": 0}, ValueError),
        (("ok",), {"tiles_per_proc": -3}, ValueError),
    ],
)
def test_argument_errors(args, kwargs, err):
    arrays = {"1d": np.ones(8, np.float32), "3d": np.ones((4, 4, 2), np.float32), "ok": _tall(64, 4)}
    for mod in (htt, htj):
        a = args[0] if args[0] not in arrays else mod.array(arrays[args[0]])
        with pytest.raises(err):
            mod.linalg.qr(a, **kwargs)


def test_integral_tiles_per_proc_and_overwrite_a():
    a = htt.array(_tall(256, 8), split=0)
    q, r = htt.linalg.qr(a, tiles_per_proc=np.int64(2))
    assert q.shape == (256, 8)
    with pytest.warns(UserWarning, match="overwrite_a"):
        htt.linalg.qr(a, overwrite_a=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        htt.linalg.qr(a)


def test_full_float32_products_inside_and_caller_setting_restored(monkeypatch):
    """qr pins full float32 products (no TF32) for its own work and gives
    the caller's setting back."""
    seen = []
    real_cholesky_ex, real_qr = torch.linalg.cholesky_ex, torch.linalg.qr
    monkeypatch.setattr(
        torch.linalg, "cholesky_ex", lambda *a, **k: seen.append(torch.get_float32_matmul_precision()) or real_cholesky_ex(*a, **k)
    )
    monkeypatch.setattr(torch.linalg, "qr", lambda *a, **k: seen.append(torch.get_float32_matmul_precision()) or real_qr(*a, **k))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        htt.linalg.qr(htt.array(_tall(256, 8)))
        htt.linalg.qr(htt.array(_tall(256, 8)), method="householder")
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(ValueError):
            htt.linalg.qr(htt.array(_tall(256, 8)), method="bad")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}


def test_qr_then_matmul_tall_skinny():
    """The ladder's last rung at a small size: qr + matmul on split=0."""
    a_np = _tall(2048, 32, seed=4)
    at, aj = htt.array(a_np, split=0), htj.array(a_np, split=0)
    gt, gj = htt.matmul(at.T, at), htj.matmul(aj.T, aj)
    _meta(gt, gj)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj.numpy()), rtol=1e-5, atol=1e-5 * np.abs(gj.numpy()).max())
    q, r = htt.linalg.qr(at)
    # RᵀR is the Gram matrix AᵀA
    np.testing.assert_allclose(r.numpy().T.astype(np.float64) @ r.numpy(), gt.numpy(), rtol=0,
                               atol=1e-5 * np.abs(gt.numpy()).max())
