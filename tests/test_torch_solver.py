"""heat_tpu_torch's iterative solvers (``linalg.cg``, ``linalg.lanczos``)
against heat_tpu's, on the CPU.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)`` (world size 1, as the port runs here). The
distributed forms run in the 4-rank gloo session of
``tests/test_torch_dist.py`` (its ``solver`` case).

- ``cg``: in float64 the iteration count equals heat_tpu's. heat_tpu's
  count is read off its own loop (``_cg_device`` with the bound ``n``
  lowered until its result changes). In float32 the recursively updated
  residual goes on shrinking below its own rounding level before it
  crosses ``r·r < 1e-20``, so where it crosses depends on the order of
  the float32 sums (19 against 21 iterations at n = 30), and only x is
  compared. x agrees within 1e-9·max|x| (float64: ~n·eps·cond(A) over the
  iterations, cond(A) < 10) and 1e-4·max|x| (float32).
- ``lanczos``: T within 1e-4·max|T| and V within 1e-4 per entry (its
  columns are unit vectors) of heat_tpu's, each V column compared after
  fixing its sign; both are Krylov bases built from float32 products
  summed in another order, whose rounding (eps·‖A‖ per step) the
  re-orthogonalization keeps from growing over the m = 12 steps. float64:
  1e-10.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context
from heat_tpu.core.linalg.solver import _cg_device

import heat_tpu_torch as htt
from heat_tpu_torch.core.linalg.solver import CG_BLOCK, _cg


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _spd(n, seed, dtype):
    g = np.random.default_rng(seed).normal(size=(n, n))
    return (g @ g.T / n + np.eye(n)).astype(dtype)


def _meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)


def _heat_tpu_cg_iterations(a, b, x0):
    """``(iterations, x)`` of heat_tpu's while-loop: the least bound under
    which its result is that of the unbounded loop, and that result."""
    import jax
    import jax.numpy as jnp

    n = a.shape[0]
    with jax.default_matmul_precision("highest"):
        args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(x0))
        full = np.asarray(_cg_device(*args, n))
        for k in range(n + 1):
            if np.array_equal(np.asarray(_cg_device(*args, k)), full):
                return k, full
    raise AssertionError("unreachable")


@pytest.mark.parametrize("n, shift", [(2, 1.0), (30, 1.0), (70, 0.02)])
def test_cg_runs_heat_tpus_iterations(n, shift):
    """n = 30 stops on the residual; n = 2 on the bound n and the residual
    at once; at n = 70 a small shift of the spectrum (cond(A) = 186) runs
    into the bound n, past two blocks of CG_BLOCK iterations."""
    g = np.random.default_rng(1).normal(size=(n, n))
    a = g @ g.T / n + shift * np.eye(n)
    b = np.random.default_rng(2).normal(size=n)
    x0 = np.zeros(n)
    want, xj = _heat_tpu_cg_iterations(a, b, x0)
    ta = torch.from_numpy(a)
    x, got = _cg(lambda v: ta @ v, torch.from_numpy(b), torch.from_numpy(x0), n)
    assert got == want and want <= n
    assert want == n > 2 * CG_BLOCK if n == 70 else want < n or n == 2
    # cond(A) = 186 at n = 70: its 70 iterations amplify the sums' rounding (measured 1.2e-8 of max|x|)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=1e-6 * np.abs(xj).max())


@pytest.mark.parametrize("split_a", [None, 0, 1])
@pytest.mark.parametrize("split_b", [None, 0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_matches_heat_tpu(split_a, split_b, dtype):
    a = _spd(24, 3, dtype)
    b = np.random.default_rng(4).normal(size=24).astype(dtype)
    x0 = (b / 3).astype(dtype)
    xt = htt.linalg.cg(htt.array(a, split=split_a), htt.array(b, split=split_b), htt.array(x0))
    xj = htj.linalg.cg(htj.array(a, split=split_a), htj.array(b, split=split_b), htj.array(x0))
    _meta(xt, xj)
    want = np.asarray(xj.numpy())
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(xt.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_allclose(a.astype(np.float64) @ xt.numpy(), b, rtol=0, atol=1e-3)


def test_cg_out_and_argument_checks():
    a, b = _spd(8, 5, np.float32), np.ones(8, np.float32)
    out = htt.zeros(8)
    res = htt.linalg.cg(htt.array(a), htt.array(b), htt.zeros(8), out=out)
    assert res is out and np.allclose(a @ out.numpy(), b, atol=1e-4)
    for pkg in (htt, htj):
        with pytest.raises(TypeError):
            pkg.linalg.cg(a, pkg.array(b), pkg.array(b))
        with pytest.raises(RuntimeError):
            pkg.linalg.cg(pkg.array(b), pkg.array(b), pkg.array(b))
        with pytest.raises(RuntimeError):
            pkg.linalg.cg(pkg.array(a), pkg.array(a), pkg.array(b))


def _signed_columns(v):
    """Each column with its largest-|entry| positive."""
    s = np.sign(v[np.abs(v).argmax(axis=0), np.arange(v.shape[1])])
    return v * np.where(s == 0, 1, s)[None, :]


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("start", ["ones", "v0"])
def test_lanczos_matches_heat_tpu(split, dtype, start):
    n, m = 40, 12
    a = _spd(n, 6, dtype)
    v0 = np.random.default_rng(7).normal(size=n).astype(dtype)
    start_t = {} if start == "ones" else {"v0": htt.array(v0, split=0)}
    start_j = {} if start == "ones" else {"v0": htj.array(v0, split=0)}
    Vt, Tt = htt.linalg.lanczos(htt.array(a, split=split), m, **start_t)
    Vj, Tj = htj.linalg.lanczos(htj.array(a, split=split), m, **start_j)
    _meta(Vt, Vj)
    _meta(Tt, Tj)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    tj = np.asarray(Tj.numpy())
    np.testing.assert_allclose(Tt.numpy(), tj, rtol=0, atol=tol * np.abs(tj).max())
    np.testing.assert_allclose(_signed_columns(Vt.numpy()), _signed_columns(np.asarray(Vj.numpy())), rtol=0, atol=tol)
    v = Vt.numpy().astype(np.float64)
    np.testing.assert_allclose(v.T @ v, np.eye(m), rtol=0, atol=10 * tol)


def test_lanczos_outputs_and_checks():
    a = _spd(20, 8, np.float32)
    V_out, T_out = htt.zeros((20, 5)), htt.zeros((5, 5))
    V, T = htt.linalg.lanczos(htt.array(a, split=0), 5, V_out=V_out, T_out=T_out)
    assert V is V_out and T is T_out
    t = T.numpy()
    assert np.array_equal(t, t.T) and np.count_nonzero(np.triu(t, 2)) == 0
    for pkg in (htt, htj):
        with pytest.raises(TypeError):
            pkg.linalg.lanczos(a, 3)
        with pytest.raises(RuntimeError):
            pkg.linalg.lanczos(pkg.array(np.ones((3, 4), np.float32)), 2)


def test_lanczos_stops_growing_in_an_invariant_subspace():
    """A of rank 2 from ones: w vanishes after two steps; the 1e-12 guards
    keep every later vector and T entry finite, as in heat_tpu."""
    u = np.stack([np.ones(16), np.arange(16.0) - 7.5], axis=1)
    a = (u @ u.T / 16).astype(np.float32)
    Vt, Tt = htt.linalg.lanczos(htt.array(a), 5)
    Vj, Tj = htj.linalg.lanczos(htj.array(a), 5)
    assert np.isfinite(Vt.numpy()).all() and np.isfinite(Tt.numpy()).all()
    np.testing.assert_allclose(Tt.numpy()[:2, :2], np.asarray(Tj.numpy())[:2, :2], rtol=0, atol=1e-4 * np.abs(a).max() * 16)
