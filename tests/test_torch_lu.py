"""heat_tpu_torch's LU surface (``linalg.solve``, ``det``, ``inv``) against
heat_tpu's, on the CPU.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)`` (world size 1, as the port runs here; both then
call their library's LU: ``jnp.linalg`` and ``torch.linalg``, each over
LAPACK's ``getrf`` on the CPU). The distributed LU runs in the 4-rank
gloo session of ``tests/test_torch_dist.py`` (its ``lu`` case).

Tolerances: both packages factor the same matrix by the same pivoted
elimination and differ only in the order of the float32 sums inside the
blocked kernels, so a solution's entries agree to within
c·n·eps·cond(A)·max|x|; the matrices here are 3·I plus a standard normal
matrix (cond(A) < 30) at n <= 40, and 1e-5·max|x| (1e-12 in float64)
covers that bound with room. A determinant is a product of n pivots,
each within a few eps: relative 1e-5 (float32), 1e-12 (float64). A
singular matrix's determinant is an exact 0 in both, and values, dtype,
``gshape``, ``split`` and ``lshape_map`` are compared everywhere.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL32, RTOL64 = 1e-5, 1e-12


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _general(n, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=(n, n)) + 3.0 * np.eye(n)).astype(dtype)


def _meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)


def _close(t, j):
    _meta(t, j)
    want = np.asarray(j.numpy())
    rtol = RTOL64 if want.dtype == np.float64 else RTOL32
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("split_a", [None, 0, 1])
@pytest.mark.parametrize("split_b", [None, 0])
@pytest.mark.parametrize("rhs", ["vector", "columns"])
def test_solve_matches_heat_tpu(split_a, split_b, rhs):
    a = _general(24, seed=1)
    rng = np.random.default_rng(2)
    b = rng.normal(size=24 if rhs == "vector" else (24, 3)).astype(np.float32)
    xt = htt.linalg.solve(htt.array(a, split=split_a), htt.array(b, split=split_b))
    xj = htj.linalg.solve(htj.array(a, split=split_a), htj.array(b, split=split_b))
    _close(xt, xj)
    np.testing.assert_allclose(a.astype(np.float64) @ xt.numpy(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtypes", [(np.float64, np.float32), (np.int32, np.float32), (np.float32, np.int64)])
def test_solve_promotes_as_heat_tpu(dtypes):
    da, db = dtypes
    a = (_general(10, seed=3) * 4).astype(da) + (np.eye(10, dtype=da) * 9 if da == np.int32 else 0)
    b = (np.arange(10) - 4).astype(db)
    _close(htt.linalg.solve(htt.array(a, split=0), htt.array(b)), htj.linalg.solve(htj.array(a, split=0), htj.array(b)))


def test_solve_rejects_what_heat_tpu_rejects():
    a, b = _general(5), np.ones(4, np.float32)
    for pkg, err in ((htt, ValueError), (htj, ValueError)):
        with pytest.raises(err):
            pkg.linalg.solve(pkg.array(a), pkg.array(b))
        with pytest.raises(RuntimeError):
            pkg.linalg.solve(pkg.array(np.ones((3, 4), np.float32)), pkg.array(np.ones(3, np.float32)))
        with pytest.raises(TypeError):
            pkg.linalg.solve(pkg.array(a), np.ones(5, np.float32))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_det_matches_heat_tpu(split, dtype):
    a = _general(20, seed=4, dtype=dtype)
    dt, dj = htt.det(htt.array(a, split=split)), htj.det(htj.array(a, split=split))
    _meta(dt, dj)
    rtol = RTOL64 if dtype == np.float64 else RTOL32
    np.testing.assert_allclose(dt.numpy(), dj.numpy(), rtol=rtol)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_det_of_a_singular_matrix_is_an_exact_zero(split):
    """A zero column makes a pivot exactly zero: its multipliers stay zero."""
    a = _general(12, seed=5)
    a[:, 4] = 0.0
    dt, dj = htt.linalg.det(htt.array(a, split=split)), htj.linalg.det(htj.array(a, split=split))
    _meta(dt, dj)
    assert float(dt.numpy()) == 0.0 == float(dj.numpy())


@pytest.mark.parametrize("split", [None, 0, 1])
def test_det_sign_of_an_odd_number_of_row_exchanges(split):
    """P diag(1..n), P exchanging rows 0 and n - 1: det = -n!."""
    n = 9
    a = np.diag(np.arange(1.0, n + 1.0)).astype(np.float32)
    a[[0, n - 1]] = a[[n - 1, 0]]
    dt, dj = htt.det(htt.array(a, split=split)), htj.det(htj.array(a, split=split))
    _meta(dt, dj)
    # jnp's det rounds the product of the pivots otherwise than the port (-362879.97 in float32)
    np.testing.assert_allclose([float(dt.numpy()), float(dj.numpy())], -362880.0, rtol=RTOL32)


def test_det_of_integers_promotes_to_float32():
    a = np.array([[1, 2, 0], [-1, 0, 2], [1, -1, 1]], np.int32)
    dt, dj = htt.det(htt.array(a, split=0)), htj.det(htj.array(a, split=0))
    _meta(dt, dj)
    np.testing.assert_allclose(dt.numpy(), dj.numpy(), rtol=RTOL32)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inv_matches_heat_tpu(split, dtype):
    a = _general(16, seed=6, dtype=dtype)
    it, ij = htt.inv(htt.array(a, split=split)), htj.inv(htj.array(a, split=split))
    _close(it, ij)
    np.testing.assert_allclose(a.astype(np.float64) @ it.numpy(), np.eye(16), rtol=0, atol=1e-4)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_batch_stacks_match_heat_tpu(split):
    """A stack split along its batch axis factors each matrix on its own
    (the result keeps the split); along a matrix axis the stack is taken
    whole (det replicated, inv keeping the split)."""
    stack = np.stack([_general(5, seed=10 + i) for i in range(4)])
    _meta(htt.det(htt.array(stack, split=split)), htj.det(htj.array(stack, split=split)))
    np.testing.assert_allclose(htt.det(htt.array(stack, split=split)).numpy(),
                               htj.det(htj.array(stack, split=split)).numpy(), rtol=RTOL32)
    _close(htt.inv(htt.array(stack, split=split)), htj.inv(htj.array(stack, split=split)))


@pytest.mark.parametrize("name", ["det", "inv"])
def test_non_square_operands_raise(name):
    for pkg in (htt, htj):
        with pytest.raises(RuntimeError):
            getattr(pkg, name)(pkg.array(np.ones((3, 4), np.float32)))
        with pytest.raises(RuntimeError):
            getattr(pkg.linalg, name)(pkg.array(np.ones(4, np.float32)))


def test_column_loop_matches_the_library():
    """heat_tpu's column loop, which the port runs where the library meets
    a zero pivot, against LAPACK's blocked getrf on a tall panel: the same
    pivots, factors within 1e-5 of max|lu| (float32 sums in another order)."""
    from heat_tpu_torch.core.linalg.factorizations import _lu_columns

    p = torch.from_numpy(np.random.default_rng(20).normal(size=(40, 12)).astype(np.float32))
    lu, piv = _lu_columns(p)
    lu0, piv0 = torch.linalg.lu_factor(p)
    assert torch.equal(piv, piv0.to(piv.dtype))
    np.testing.assert_allclose(lu.numpy(), lu0.numpy(), rtol=0, atol=RTOL32 * float(lu0.abs().max()))


def test_a_library_that_divides_zero_by_zero_is_not_trusted(monkeypatch):
    """Where the factorization reports an exactly zero pivot (info > 0) the
    port refactors by the column loop, whatever the library left (a card's
    getrf leaves 0/0 = NaN multipliers): det is an exact 0 and the panel's
    factor finite, the zero pivot's multipliers zero."""
    from heat_tpu_torch.core.linalg import factorizations as F

    real = torch.linalg.lu_factor_ex

    def nan_on_zero_pivot(t):
        lu, piv, info = real(t)
        return torch.where(info.reshape(info.shape + (1, 1)) > 0, float("nan"), lu), piv, info

    monkeypatch.setattr(torch.linalg, "lu_factor_ex", nan_on_zero_pivot)
    a = _general(10, seed=21)
    a[:, 3] = 0.0
    stack = torch.from_numpy(np.stack([_general(10, seed=22), a]))
    d = F._det_local(stack)
    assert float(d[1]) == 0.0 and np.isclose(float(d[0]), np.linalg.det(stack[0].double().numpy()), rtol=RTOL32)
    lu, piv = F._lu_factor(torch.from_numpy(a))
    assert torch.isfinite(lu).all() and (lu[4:, 3] == 0).all() and float(lu[3, 3]) == 0.0
    assert float(htt.det(htt.array(a, split=0)).numpy()) == 0.0


def test_full_float32_products_inside_and_caller_setting_restored(monkeypatch):
    """solve, det and inv pin full float32 products (no TF32), as heat_tpu
    runs them at default_matmul_precision("highest"), and give the caller's
    setting back."""
    seen = {}
    for name in ("solve", "lu_factor_ex", "inv"):
        real = getattr(torch.linalg, name)
        monkeypatch.setattr(torch.linalg, name, lambda *a, _n=name, _f=real, **k:
                            seen.setdefault(_n, torch.get_float32_matmul_precision()) and _f(*a, **k))
    a = htt.array(_general(12, seed=23))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        htt.linalg.solve(a, htt.array(np.ones(12, np.float32)))
        htt.det(a)
        htt.inv(a)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == {"solve": "highest", "lu_factor_ex": "highest", "inv": "highest"}
