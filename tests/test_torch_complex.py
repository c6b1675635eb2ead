"""heat_tpu_torch's complex numbers against heat_tpu, on the CPU:
``complex_math`` (``angle``, ``conj``/``conjugate``, ``imag``, ``real``),
``DNDarray.real``/``.imag``, ``iscomplex``/``isreal``, the lexicographic
order (comparisons, ``min``/``max``, ``minimum``/``maximum``), the complex
products (``matmul``, ``dot``, ``vdot`` and ``vecdot``, which conjugate
their first argument) and the half-precision ``matmul``, and the calls
heat_tpu refuses for complex input. heat_tpu runs under
``comm_context(SELF)``, at world size 1 as the port does.

Tolerances: comparisons, extrema and the parts of a number exact; the
elementwise functions and products rtol 1e-6 (complex64 arithmetic in
another order: a few float32 ulp); half-precision products within four
units of the type's roundoff of the largest entry (both accumulate in
float32 and round once; the float32 sums differ by a few ulp).
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL = 1e-6
HALF_RTOL = {"float16": 4 * 2.0 ** -11, "bfloat16": 4 * 2.0 ** -8}


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _host(j):
    a = np.asarray(j.numpy())
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same(t, j, rtol=RTOL, exact=False):
    assert isinstance(t, htt.DNDarray) and isinstance(j, htj.DNDarray), (type(t), type(j))
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    tn, jn = t.numpy(), _host(j)
    if exact or tn.dtype.kind in "biu":
        np.testing.assert_array_equal(tn, jn)
    else:
        np.testing.assert_allclose(tn, jn, rtol=rtol, atol=rtol * (np.abs(jn).max() if jn.size else 0))


def _both(a, split=0):
    return htt.array(a, split=split), htj.array(a, split=split)


_rng = np.random.default_rng(11)
C = (_rng.normal(size=(6, 4)) + 1j * _rng.normal(size=(6, 4))).astype(np.complex64)
# equal real parts in many places: the imaginary part decides the order
TIES = (np.round(_rng.normal(size=(6, 4))) + 1j * np.round(_rng.normal(size=(6, 4)) * 2)).astype(np.complex64)
R = _rng.normal(size=(6, 4)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32, np.int16])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex_math(dtype, split):
    a = C.astype(dtype) if np.dtype(dtype).kind == "c" else (R * 4).astype(dtype)
    t, j = _both(a, split)
    for name in ("conj", "conjugate", "imag", "real"):
        _same(getattr(htt, name)(t), getattr(htj, name)(j), exact=True)
    _same(htt.angle(t), htj.angle(j))
    _same(htt.angle(t, deg=True), htj.angle(j, deg=True))
    _same(t.real, j.real, exact=True)
    _same(t.imag, j.imag, exact=True)
    _same(htt.iscomplex(t), htj.iscomplex(j))
    _same(htt.isreal(t), htj.isreal(j))


def test_real_of_a_real_array_is_the_array():
    t = htt.array(R)
    assert htt.real(t) is t and t.real is t
    c = htt.array(C)
    assert htt.real(c) is not c


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne", "maximum", "minimum"])
@pytest.mark.parametrize("other", ["array", "row", "scalar", "real"])
def test_lexicographic_comparisons(op, other):
    t, j = _both(TIES)
    if other == "array":
        u, k = _both(TIES[::-1].copy())
    elif other == "row":
        u, k = _both(TIES[2], None)
    elif other == "scalar":
        u = k = 1 - 1j
    else:
        u, k = _both(np.round(R))
    _same(getattr(htt, op)(t, u), getattr(htj, op)(j, k), exact=True)


def test_lexicographic_order_of_the_probe():
    """max([1+5j, 1+2j, 9j]) is 1+5j in heat_tpu: real part first."""
    a = np.array([1 + 5j, 1 + 2j, 9j], np.complex64)
    t, j = _both(a)
    assert complex(htt.max(t).item()) == complex(htj.max(j).item()) == 1 + 5j
    assert complex(htt.min(t).item()) == complex(htj.min(j).item()) == 9j
    _same(t < htt.array(np.array([1 + 6j, 1 + 1j, 1j], np.complex64), split=0),
          j < htj.array(np.array([1 + 6j, 1 + 1j, 1j], np.complex64), split=0), exact=True)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex_extrema(split, axis, keepdims):
    t, j = _both(TIES, split)
    for name in ("max", "min", "nanmax", "nanmin"):
        _same(getattr(htt, name)(t, axis=axis, keepdims=keepdims), getattr(htj, name)(j, axis=axis, keepdims=keepdims),
              exact=True)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex_sums_and_moments(split):
    t, j = _both(C, split)
    for axis in (None, 0, 1):
        for name in ("sum", "prod", "mean", "var", "std", "cumsum"):
            if name == "cumsum" and axis is None:
                continue
            fn_t, fn_j = getattr(htt, name), getattr(htj, name)
            if name == "cumsum":
                _same(fn_t(t, axis), fn_j(j, axis))
            else:
                _same(fn_t(t, axis=axis), fn_j(j, axis=axis), rtol=1e-5)  # sums of 24 terms in another order


@pytest.mark.parametrize("name", ["argmax", "argmin", "floor", "ceil", "trunc", "fabs", "cbrt", "median",
                                  "isposinf", "isneginf", "signbit"])
def test_calls_heat_tpu_refuses_for_complex(name):
    t, j = _both(C)
    with pytest.raises(Exception) as want:
        getattr(htj, name)(j)
    with pytest.raises(want.type):
        getattr(htt, name)(t)


@pytest.mark.parametrize("name", ["floordiv", "mod", "fmod", "hypot", "copysign"])
def test_binary_calls_heat_tpu_refuses_for_complex(name):
    t, j = _both(C)
    with pytest.raises(Exception) as want:
        getattr(htj, name)(j, 2.0)
    with pytest.raises(want.type):
        getattr(htt, name)(t, 2.0)


@pytest.mark.parametrize("name", ["exp", "log", "sqrt", "sin", "cos", "tanh", "square", "sign", "sgn", "round",
                                  "abs", "deg2rad", "rad2deg"])
def test_complex_elementwise(name):
    t, j = _both(C)
    _same(getattr(htt, name)(t), getattr(htj, name)(j))
    _same(t ** 2, j ** 2)
    _same(t ** 0.5, j ** 0.5)


@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0), (0, 0), (1, 0)])
def test_complex_products(splits):
    a = C
    b = (_rng.normal(size=(4, 3)) + 1j * _rng.normal(size=(4, 3))).astype(np.complex64)
    ta, ja = _both(a, splits[0])
    tb, jb = _both(b, splits[1])
    _same(htt.matmul(ta, tb), htj.matmul(ja, jb))
    _same(htt.matmul(htt.conj(ta).T, ta), htj.matmul(htj.conj(ja).T, ja))
    v, w = C[:, 0].copy(), C[:, 1].copy()
    tv, jv = _both(v, None if splits[0] is None else 0)
    tw, jw = _both(w, splits[1])
    _same(htt.dot(tv, tw), htj.dot(jv, jw))
    _same(htt.vdot(tv, tw), htj.vdot(jv, jw))
    _same(htt.vdot(ta, ta), htj.vdot(ja, ja))
    _same(htt.vecdot(ta, ta), htj.vecdot(ja, ja))
    _same(htt.vecdot(ta, ta, axis=0), htj.vecdot(ja, ja, axis=0))
    _same(htt.linalg.outer(tv, tw), htj.linalg.outer(jv, jw))


def test_vdot_conjugates_its_first_argument():
    a = np.array([1j, 2], np.complex64)
    b = np.array([1j, 1], np.complex64)
    assert complex(htt.vdot(htt.array(a), htt.array(b)).item()) == np.vdot(a, b) == 3
    assert complex(htt.dot(htt.array(a), htt.array(b)).item()) == np.dot(a, b) == 1


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_half_precision_matmul(dtype, split):
    a = _rng.normal(size=(64, 8)).astype(np.float32)
    t, j = _both(a, split)
    t, j = t.astype(getattr(htt, dtype)), j.astype(getattr(htj, dtype))
    _same(htt.matmul(t.T, t), htj.matmul(j.T, j), rtol=HALF_RTOL[dtype])
    _same(t @ htt.array(a[:8].T.copy()).astype(getattr(htt, dtype)),
          j @ htj.array(a[:8].T.copy()).astype(getattr(htj, dtype)), rtol=HALF_RTOL[dtype])


def test_complex_setitem_getitem_and_creation():
    t, j = _both(C)
    t[1, 2] = 5 - 5j
    j[1, 2] = 5 - 5j
    _same(t, j, exact=True)
    _same(t[2:5, ::2], j[2:5, ::2], exact=True)
    _same(htt.array([1 + 2j, 3]), htj.array([1 + 2j, 3]), exact=True)  # python complex: complex128
    _same(htt.zeros((2, 2), dtype=htt.complex), htj.zeros((2, 2), dtype=htj.complex), exact=True)
