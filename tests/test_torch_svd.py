"""heat_tpu_torch's ``svd``, ``rsvd``, ``lstsq`` and ``pinv``, and the
vector products ``vdot``, ``vecdot``, ``cross`` and ``projection``,
against heat_tpu's, on the CPU.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)`` (world size 1, as the port runs here: the SVD of
the whole array, as in heat_tpu). TSQR's route runs in the 4-rank gloo
session of ``tests/test_torch_dist.py`` (its ``svd`` case).

Tolerances: singular values within 1e-5·max(S) (float32; both packages
call LAPACK's ``gesdd`` on the same array); a singular pair is defined up
to a common sign, so U's and Vh's are compared after fixing it (largest
|entry| of each Vh row positive), within 1e-4 per entry (unit vectors of
a well-separated spectrum: the perturbation is eps·‖A‖/gap), and
U·diag(S)·Vh reconstructs A within 1e-5·max|A|. ``lstsq`` and ``pinv``
within 1e-4 relative to their largest entry (cond(A) < 10 here).
``rsvd``'s test matrix is compared exactly against jax's draw from the
same key, up to float32 ``erfinv`` rounding (4 ulp, as
``tests/test_torch_random.py`` holds ``randn``). Products of vectors:
float results within 1e-6 relative, integer results exact.
"""
import jax
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.core import random as port_random

S_RTOL, VEC_ATOL, RECON_RTOL, SOLVE_RTOL = 1e-5, 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _meta(t, j):
    assert t.dtype.__name__ == j.dtype.__name__
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)


def _signs_fixed(u, vh):
    s = np.sign(vh[np.arange(vh.shape[0]), np.abs(vh).argmax(axis=1)])
    return u * s[None, :], vh * s[:, None]


def _data(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check_svd(rt, rj, a):
    for t, j in zip(rt, rj):
        _meta(t, j)
    (ut, st, vt), (uj, sj, vj) = [[np.asarray(x.numpy()) for x in r] for r in (rt, rj)]
    np.testing.assert_allclose(st, sj, rtol=0, atol=S_RTOL * sj.max())
    ut, vt = _signs_fixed(ut, vt)
    uj, vj = _signs_fixed(uj, vj)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=VEC_ATOL)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=VEC_ATOL)
    recon = (ut.astype(np.float64) * st) @ vt
    np.testing.assert_allclose(recon, a, rtol=0, atol=RECON_RTOL * np.abs(a).max())


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(200, 8), (6, 20)])
def test_svd_matches_heat_tpu(split, shape):
    a = _data(shape, 1)
    _check_svd(htt.linalg.svd(htt.array(a, split=split)), htj.linalg.svd(htj.array(a, split=split)), a)
    st = htt.linalg.svd(htt.array(a, split=split), compute_uv=False)
    sj = htj.linalg.svd(htj.array(a, split=split), compute_uv=False)
    _meta(st, sj)
    np.testing.assert_allclose(st.numpy(), sj.numpy(), rtol=0, atol=S_RTOL * float(sj.numpy().max()))


def test_svd_full_matrices_and_checks():
    a = _data((7, 4), 2)
    ut, st, vt = htt.linalg.svd(htt.array(a), full_matrices=True)
    uj, sj, vj = htj.linalg.svd(htj.array(a), full_matrices=True)
    _meta(ut, uj)
    _meta(vt, vj)
    for pkg in (htt, htj):
        with pytest.raises(NotImplementedError):
            pkg.linalg.svd(pkg.array(a, split=0), full_matrices=True)
        with pytest.raises(ValueError):
            pkg.linalg.svd(pkg.array(np.ones(3, np.float32)))
        with pytest.raises(TypeError):
            pkg.linalg.svd(a)


def test_rsvd_draws_heat_tpus_test_matrix(monkeypatch):
    """The same random_state gives jax's normal(fold_in(PRNGKey(s), k n))."""
    drawn = []
    real = port_random._normal_tensor

    def capture(*args):
        drawn.append(real(*args))
        return drawn[-1]

    monkeypatch.setattr(port_random, "_normal_tensor", capture)
    a = _data((300, 40), 3)
    htt.linalg.rsvd(htt.array(a, split=0), 5, random_state=11)
    k = 5 + 10
    want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(11), k * 40), (40, k), dtype=np.float32))
    got = drawn[0].numpy()
    assert got.shape == (40, k)
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps, atol=4 * np.finfo(np.float32).tiny)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_rsvd_matches_heat_tpu(split):
    """A of exact rank 6 under noise: rank 4 with the same random_state."""
    rng = np.random.default_rng(4)
    low = (rng.normal(size=(300, 6)) * [50, 30, 20, 10, 5, 2]) @ rng.normal(size=(6, 40))
    a = (low + 0.01 * rng.normal(size=low.shape)).astype(np.float32)
    rt = htt.linalg.rsvd(htt.array(a, split=split), 4, random_state=7)
    rj = htj.linalg.rsvd(htj.array(a, split=split), 4, random_state=7)
    for t, j in zip(rt, rj):
        _meta(t, j)
    (ut, st, vt), (uj, sj, vj) = [[np.asarray(x.numpy()) for x in r] for r in (rt, rj)]
    np.testing.assert_allclose(st, sj, rtol=0, atol=S_RTOL * sj.max())
    ut, vt = _signs_fixed(ut, vt)
    uj, vj = _signs_fixed(uj, vj)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=VEC_ATOL)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=VEC_ATOL)


def test_rsvd_without_random_state_moves_the_global_stream():
    a = _data((50, 12), 5)
    for pkg in (htt, htj):
        pkg.random.seed(3)
    rt = htt.linalg.rsvd(htt.array(a, split=0), 2, n_oversamples=3, n_iter=1)
    rj = htj.linalg.rsvd(htj.array(a, split=0), 2, n_oversamples=3, n_iter=1)
    assert htt.random.get_state() == htj.random.get_state() == ("Threefry", 3, 5 * 12, 0, 0.0)
    np.testing.assert_allclose(rt.S.numpy(), rj.S.numpy(), rtol=0, atol=S_RTOL * float(rj.S.numpy().max()))
    for pkg in (htt, htj):
        with pytest.raises(ValueError):
            pkg.linalg.rsvd(pkg.array(a), 0)


def _solve_close(t, j):
    _meta(t, j)
    want = np.asarray(j.numpy())
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=SOLVE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("split_a", [None, 0, 1])
@pytest.mark.parametrize("rhs", ["vector", "columns"])
def test_lstsq_qr_route_matches_heat_tpu(split_a, rhs):
    a = _data((120, 6), 6)
    b = _data(120 if rhs == "vector" else (120, 2), 7)
    _solve_close(htt.linalg.lstsq(htt.array(a, split=split_a), htt.array(b, split=0)),
                 htj.linalg.lstsq(htj.array(a, split=split_a), htj.array(b, split=0)))


@pytest.mark.parametrize("case", ["rank_deficient", "rcond", "wide"])
def test_lstsq_pinv_route_matches_heat_tpu(case):
    """R's guard fails for a repeated column; an rcond or a wide array
    skips the QR route: both packages take the minimum-norm solution."""
    a = _data((120, 6) if case != "wide" else (5, 9), 8)
    if case == "rank_deficient":
        a[:, 4] = a[:, 1]
    b = _data(a.shape[0], 9)
    kw = {"rcond": 1e-3} if case == "rcond" else {}
    _solve_close(htt.linalg.lstsq(htt.array(a, split=0), htt.array(b), **kw),
                 htj.linalg.lstsq(htj.array(a, split=0), htj.array(b), **kw))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("rcond", [None, 0.2])
def test_pinv_matches_heat_tpu(split, rcond):
    a = _data((40, 7), 10)
    a[:, 6] *= 0.1  # a singular value near 0.2 of the largest
    _solve_close(htt.linalg.pinv(htt.array(a, split=split), rcond=rcond),
                 htj.linalg.pinv(htj.array(a, split=split), rcond=rcond))


def _value_close(t, j):
    _meta(t, j)
    want = np.asarray(j.numpy())
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(t.numpy(), want)
    else:
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtypes", [(np.float32, np.float32), (np.int32, np.int32), (np.float32, np.float64),
                                    (np.int32, np.float32)])
@pytest.mark.parametrize("splits", [(None, None), (0, None), (0, 1)])
def test_vdot_matches_heat_tpu(dtypes, splits):
    a = (_data((6, 5), 11) * 4).astype(dtypes[0])
    b = (_data((6, 5), 12) * 4).astype(dtypes[1])
    _value_close(htt.vdot(htt.array(a, split=splits[0]), htt.array(b, split=splits[1])),
                 htj.vdot(htj.array(a, split=splits[0]), htj.array(b, split=splits[1])))


@pytest.mark.parametrize("axis", [None, 0, 1, -2])
@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 1), (1, 1)])
@pytest.mark.parametrize("keepdims", [False, True])
def test_vecdot_matches_heat_tpu(axis, splits, keepdims):
    a, b = _data((6, 5), 13), _data((6, 5), 14)
    _value_close(htt.vecdot(htt.array(a, split=splits[0]), htt.array(b, split=splits[1]), axis=axis, keepdims=keepdims),
                 htj.vecdot(htj.array(a, split=splits[0]), htj.array(b, split=splits[1]), axis=axis, keepdims=keepdims))


def test_vecdot_types_and_broadcast_match_heat_tpu():
    ia = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    _value_close(htt.linalg.vecdot(htt.array(ia, split=0), htt.array(ia)), htj.linalg.vecdot(htj.array(ia, split=0), htj.array(ia)))
    row = _data((4,), 15)
    _value_close(htt.vecdot(htt.array(ia.astype(np.float32), split=1), htt.array(row)),
                 htj.vecdot(htj.array(ia.astype(np.float32), split=1), htj.array(row)))


@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0)])
def test_projection_matches_heat_tpu(splits):
    a, b = _data(9, 16), _data(9, 17)
    _value_close(htt.projection(htt.array(a, split=splits[0]), htt.array(b, split=splits[1])),
                 htj.projection(htj.array(a, split=splits[0]), htj.array(b, split=splits[1])))
    for pkg in (htt, htj):
        with pytest.raises(RuntimeError):
            pkg.projection(pkg.array(np.ones((2, 2), np.float32)), pkg.array(b))


@pytest.mark.parametrize("shapes", [((5, 3), (5, 3)), ((5, 2), (5, 2)), ((5, 2), (5, 3)), ((4, 1, 3), (5, 3))])
@pytest.mark.parametrize("split", [None, 0])
def test_cross_matches_heat_tpu(shapes, split):
    a, b = _data(shapes[0], 18), _data(shapes[1], 19)
    _value_close(htt.cross(htt.array(a, split=split), htt.array(b)), htj.cross(htj.array(a, split=split), htj.array(b)))


@pytest.mark.parametrize("kw", [{"axis": 0}, {"axisa": 0, "axisb": 0}, {"axisa": 0, "axisb": 0, "axisc": 0}])
def test_cross_axes_match_heat_tpu(kw):
    a, b = _data((3, 6), 20), _data((3, 6), 21)
    _value_close(htt.linalg.cross(htt.array(a, split=1), htt.array(b), **kw),
                 htj.linalg.cross(htj.array(a, split=1), htj.array(b), **kw))
    for pkg in (htt, htj):
        with pytest.raises(ValueError):
            pkg.cross(pkg.array(np.ones((2, 4), np.float32)), pkg.array(np.ones((2, 4), np.float32)))


def test_tall_arrays_take_qr_and_the_svd_of_r():
    """A tall split-0 or replicated array goes through qr at world size 1
    too (heat_tpu's route above it); a wide or column-split one takes the
    whole array's SVD."""
    for shape, split, via_qr in (((200, 8), 0, True), ((200, 8), None, True), ((200, 8), 1, False),
                                 ((6, 20), 0, False)):
        htt.kernels.reset_kernel_stats()
        htt.linalg.svd(htt.array(_data(shape, 23), split=split))
        assert any(k.startswith("qr.") for k in htt.KERNEL_STATS) == via_qr, (shape, split)
