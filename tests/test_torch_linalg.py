"""heat_tpu_torch's Cholesky / kernel-ridge path against heat_tpu, on the CPU.

The same numpy inputs, made from a seed, go through both packages: ``eye``,
``spatial.rbf``, ``matmul``, ``transpose``/``.T``, ``linalg.cholesky`` and
``linalg.solve_triangular``, and the kernel-ridge solve built from them.
heat_tpu's Cholesky kernel does not run in interpret mode on this JAX
(ROADMAP Queue C), so its Cholesky is taken on its CPU route
(``jnp.linalg.cholesky``, or the distributed factorization for a split
operand on the test mesh), and both are also held against
``np.linalg.cholesky`` in float64.

Tolerances (float32 unless stated): Cholesky factors rtol 2e-4 / atol 2e-5
(float32 sums in another order, on matrices with eigenvalues in [1, ~5]);
products and rbf 1e-5 relative; triangular solves 1e-4 relative; float64
results 1e-10. Values, dtypes, ``gshape`` and ``split`` are compared.
"""
import contextlib

import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt


@pytest.fixture
def cpu():
    """Run the port on the CPU for one test, then restore the default."""
    htt.use_device("cpu")
    htt.kernels.reset_kernel_stats()
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


def _spd(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n))
    return (g @ g.T / n + np.eye(n)).astype(dtype)


def _same_meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split


# --------------------------------------------------------------- cholesky
@pytest.mark.parametrize("n", [1, 8, 129, 300])
@pytest.mark.parametrize("split", [None, 0])
def test_cholesky_matches_heat_tpu_and_numpy(cpu, n, split):
    a = _spd(n, n)
    Lj = htj.linalg.cholesky(htj.array(a, split=split))
    Lt = htt.linalg.cholesky(htt.array(a, split=split))
    _same_meta(Lt, Lj)
    assert htt.KERNEL_STATS == {"dispatches": 1, "chol_panel_fused.torch": 1}
    np.testing.assert_allclose(Lt.numpy(), Lj.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Lt.numpy(), np.linalg.cholesky(a.astype(np.float64)), rtol=2e-4, atol=2e-5)
    assert (np.triu(Lt.numpy(), 1) == 0).all()


@pytest.mark.parametrize("n,dtype", [(64, np.float64), (1030, np.float32)])
def test_cholesky_non_kernel_route(cpu, n, dtype):
    """float64, or n above MAX_FUSED_N, take heat_tpu's non-kernel route."""
    a = _spd(n, 1, dtype)
    Lt = htt.linalg.cholesky(htt.array(a))
    assert htt.KERNEL_STATS == {"dispatches": 1, "chol_panel_fused.fallback": 1}
    Lj = htj.linalg.cholesky(htj.array(a))
    _same_meta(Lt, Lj)
    tol = 1e-10 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(Lt.numpy(), Lj.numpy(), rtol=tol * 10, atol=tol)
    np.testing.assert_allclose(Lt.numpy(), np.linalg.cholesky(a.astype(np.float64)), rtol=tol * 10, atol=tol)


def test_cholesky_not_positive_definite_non_kernel_route(cpu):
    """jnp.linalg.cholesky's answer: NaN on and below the diagonal, zeros
    above; torch.linalg.cholesky_ex's own output is replaced by it."""
    a = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    Lj = htj.linalg.cholesky(htj.array(a)).numpy()
    Lt = htt.linalg.cholesky(htt.array(a)).numpy()
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    np.testing.assert_array_equal(np.isnan(Lt), np.tril(np.ones((3, 3), bool)))
    assert (np.triu(Lt, 1) == 0).all() and (np.triu(Lj, 1) == 0).all()


@pytest.mark.parametrize("case", ["pivot25_n60", "two_by_two"])
def test_cholesky_not_positive_definite_kernel_route(cpu, case):
    """On the kernel's route nothing raises, and the NaN mask is exactly
    heat_tpu's (jnp's): NaN on and below the whole diagonal, zeros above,
    though the kernel's plain version leaves NaN only from the failing
    pivot on."""
    if case == "two_by_two":
        a = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
        pivot = 1
    else:
        a = _spd(60, 3)
        a[25, 25] = -50.0
        pivot = 25
    Lt = htt.linalg.cholesky(htt.array(a)).numpy()
    assert htt.KERNEL_STATS == {"dispatches": 1, "chol_panel_fused.torch": 1}
    with comm_context(SELF):
        Lj = htj.linalg.cholesky(htj.array(a)).numpy()
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    np.testing.assert_array_equal(np.isnan(Lt), np.tril(np.ones(a.shape, bool)))
    assert (np.triu(Lt, 1) == 0).all()
    # the plain version itself still starts its NaNs at the failing pivot
    raw = htt.kernels.chol_panels(torch.from_numpy(a), htt.kernels.chol_block_size(a.shape[0])).numpy()
    i, j = np.indices(a.shape)
    np.testing.assert_array_equal(np.isnan(raw), (i >= j) & (j >= pivot))


def test_cholesky_input_checks(cpu):
    for make, err in (
        (lambda: htt.zeros((3, 4)), RuntimeError),
        (lambda: htt.zeros(3), ValueError),
    ):
        with pytest.raises(err):
            htt.linalg.cholesky(make())
    with pytest.raises(TypeError):
        htt.linalg.cholesky(np.eye(2))


def test_cholesky_int_input_promotes_to_float32(cpu):
    a = (np.eye(4) * 4).astype(np.int32)
    Lt, Lj = htt.linalg.cholesky(htt.array(a)), htj.linalg.cholesky(htj.array(a))
    _same_meta(Lt, Lj)
    np.testing.assert_array_equal(Lt.numpy(), np.eye(4) * 2)


# ------------------------------------------------------- solve_triangular
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit_diagonal", [False, True])
@pytest.mark.parametrize("rhs_shape", [(50,), (50, 3)])
def test_solve_triangular_matches_heat_tpu(cpu, lower, unit_diagonal, rhs_shape):
    rng = np.random.default_rng(7)
    # small off-diagonal entries keep the unit-diagonal system well conditioned;
    # the other triangle holds noise that must not be read
    a = np.tril(rng.normal(size=(50, 50)), -1) * 0.05 + 10 * np.eye(50) + np.triu(rng.normal(size=(50, 50)), 1)
    a = (a if lower else a.T).astype(np.float32)
    b = rng.normal(size=rhs_shape).astype(np.float32)
    with comm_context(SELF):  # world size 1, as the port runs
        xj = htj.linalg.solve_triangular(htj.array(a, split=0), htj.array(b), lower=lower, unit_diagonal=unit_diagonal)
    xt = htt.linalg.solve_triangular(htt.array(a, split=0), htt.array(b), lower=lower, unit_diagonal=unit_diagonal)
    _same_meta(xt, xj)
    assert xt.dtype is htt.float32 and xt.gshape == rhs_shape and xt.split is None
    np.testing.assert_allclose(xt.numpy(), xj.numpy(), rtol=1e-4, atol=1e-5)
    tri = np.tril(a) if lower else np.triu(a)
    if unit_diagonal:
        np.fill_diagonal(tri, 1.0)
    np.testing.assert_allclose(tri.astype(np.float64) @ xt.numpy(), b, rtol=1e-4, atol=1e-4)


def test_solve_triangular_checks_and_float64(cpu):
    a = np.triu(_spd(6, 2, np.float64))
    b = np.arange(6.0)
    xt = htt.linalg.solve_triangular(htt.array(a), htt.array(b))
    xj = htj.linalg.solve_triangular(htj.array(a), htj.array(b))
    _same_meta(xt, xj)
    np.testing.assert_allclose(xt.numpy(), xj.numpy(), rtol=1e-10)
    with pytest.raises(ValueError, match="mismatch"):
        htt.linalg.solve_triangular(htt.array(a), htt.zeros(5))
    with pytest.raises(TypeError):
        htt.linalg.solve_triangular(htt.array(a), b)
    with pytest.raises(ValueError):
        htt.linalg.solve_triangular(htt.array(a), htt.zeros((6, 2, 1)))


# ------------------------------------------------------ matmul, transpose
@pytest.mark.parametrize(
    "sa,sb,split_a,split_b",
    [
        ((6, 5), (5, 4), None, None),
        ((6, 5), (5, 4), 0, None),
        ((6, 5), (5, 4), 1, 0),
        ((6, 5), (5, 4), None, 1),
        ((6, 5), (5,), 0, None),
        ((5,), (5, 4), None, 1),
        ((5,), (5,), 0, 0),
        ((3, 6, 5), (5, 4), 0, None),
        ((2, 6, 5), (2, 5, 4), 1, None),
    ],
)
def test_matmul_matches_heat_tpu(cpu, sa, sb, split_a, split_b):
    rng = np.random.default_rng(len(sa) * 10 + len(sb))
    a = rng.normal(size=sa).astype(np.float32)
    b = rng.normal(size=sb).astype(np.float32)
    rj = htj.matmul(htj.array(a, split=split_a), htj.array(b, split=split_b))
    rt = htt.array(a, split=split_a) @ htt.array(b, split=split_b)
    _same_meta(rt, rj)
    np.testing.assert_allclose(rt.numpy(), rj.numpy(), rtol=1e-5, atol=1e-5)
    assert htt.linalg.matmul is htt.matmul


def test_matmul_checks_and_promotion(cpu):
    with pytest.raises(ValueError, match="mismatch"):
        htt.matmul(htt.zeros((2, 3)), htt.zeros((2, 3)))
    with pytest.raises(TypeError):
        htt.matmul(htt.zeros((2, 3)), np.zeros((3, 2)))
    with pytest.raises(ValueError):
        htt.matmul(htt.array(1.0), htt.zeros(2))
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = np.ones((3, 2), dtype=np.float64)
    rt, rj = htt.matmul(htt.array(a), htt.array(b)), htj.matmul(htj.array(a), htj.array(b))
    _same_meta(rt, rj)
    np.testing.assert_array_equal(rt.numpy(), rj.numpy())


@pytest.mark.parametrize("shape,split,axes", [((4, 6), 0, None), ((4, 6), 1, None), ((4, 6), None, None), ((2, 3, 5), 2, (1, 2, 0)), ((2, 3, 5), 0, (-1, 0, 1))])
def test_transpose_matches_heat_tpu(cpu, shape, split, axes):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    tj = htj.transpose(htj.array(a, split=split), axes)
    tt = htt.transpose(htt.array(a, split=split), axes)
    _same_meta(tt, tj)
    np.testing.assert_array_equal(tt.numpy(), tj.numpy())
    if axes is None:
        _same_meta(htt.array(a, split=split).T, tj)
        np.testing.assert_array_equal(htt.array(a, split=split).T.numpy(), a.T)
    with pytest.raises(ValueError):
        htt.transpose(htt.array(a), (0,) * len(shape))


# ------------------------------------------------------------- eye, rbf
@pytest.mark.parametrize(
    "shape,dtype,split", [(4, htt.float32, None), ((3,), htt.int32, 0), ((3, 5), htt.float64, 1), ((5, 2), htt.int64, 0)]
)
def test_eye_matches_heat_tpu(cpu, shape, dtype, split):
    et = htt.eye(shape, dtype=dtype, split=split)
    ej = htj.eye(shape, dtype=getattr(htj, dtype.__name__), split=split)
    _same_meta(et, ej)
    np.testing.assert_array_equal(et.numpy(), ej.numpy())
    with pytest.raises(NotImplementedError):
        htt.eye(3, order="F")


@pytest.mark.parametrize("with_y,split_x,split_y,sigma", [(False, None, None, 1.0), (True, 0, None, 2.5), (True, None, 0, 0.7)])
def test_rbf_matches_heat_tpu(cpu, with_y, split_x, split_y, sigma):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    y = rng.normal(size=(20, 4)).astype(np.float32)
    yj = htj.array(y, split=split_y) if with_y else None
    yt = htt.array(y, split=split_y) if with_y else None
    kj = htj.spatial.rbf(htj.array(x, split=split_x), yj, sigma=sigma)
    kt = htt.spatial.rbf(htt.array(x, split=split_x), yt, sigma=sigma)
    _same_meta(kt, kj)
    np.testing.assert_allclose(kt.numpy(), kj.numpy(), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------- the kernel-ridge slice
@pytest.mark.parametrize("split", [None, 0])
def test_kernel_ridge_slice_matches_heat_tpu(cpu, split):
    """K = rbf(X, X) + I, L = cholesky(K), alpha = L^-T L^-1 y: the path
    ``chip_smoke.py`` runs at n = 1024, here at n = 160. heat_tpu runs at
    world size 1 (its SELF communicator), as the port does: on the test
    mesh a split operand would take its distributed solver, whose result
    is split where the replicated solver's is not."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(160, 8)).astype(np.float32)
    y = rng.normal(size=160).astype(np.float32)
    out = {}
    for name, ht in (("j", htj), ("t", htt)):
        with comm_context(SELF) if ht is htj else contextlib.nullcontext():
            K = ht.spatial.rbf(ht.array(x, split=split), ht.array(x, split=split), sigma=8 ** 0.5) + 1.0 * ht.eye(160)
            L = ht.linalg.cholesky(K)
            yv = ht.array(y, split=split)
            alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, yv, lower=True), lower=False)
        out[name] = (K, L, alpha)
    for t, j in zip(out["t"], out["j"]):
        _same_meta(t, j)
    np.testing.assert_allclose(out["t"][1].numpy(), out["j"][1].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out["t"][2].numpy(), out["j"][2].numpy(), rtol=1e-3, atol=1e-4)
    K64 = out["t"][0].numpy().astype(np.float64)
    assert np.linalg.norm(K64 @ out["t"][2].numpy() - y) / np.linalg.norm(y) < 1e-4
    assert htt.KERNEL_STATS["chol_panel_fused.torch"] == 1
    assert isinstance(out["t"][1].larray, torch.Tensor)
