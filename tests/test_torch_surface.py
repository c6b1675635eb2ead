"""heat_tpu_torch's elementwise/relational/extrema array surface against
heat_tpu, on the CPU.

The same numpy inputs, made from a seed, go through both packages:
``exponential``, ``trigonometrics``, ``rounding``, ``logical``,
``relational``, the arithmetic names, ``min``/``max``/``argmin``/
``argmax``/``minimum``/``maximum``/``nanmin``/``nanmax``, ``where``/
``nonzero``, ``copy``, the DNDarray dunders and methods, and the
``linalg`` basics ``tril``/``triu``/``norm``/``vector_norm``/
``matrix_norm``/``dot``/``outer``/``trace``. heat_tpu runs under
``comm_context(SELF)``, at world size 1 as the port does, so
``lshape_map`` is comparable.

Tolerances: bool and integer results, and every arg* index, exact; float
elementwise results rtol 1e-6 (a few float32 ulp: XLA's and torch's
transcendental functions may round differently in the last bits), and for
``logaddexp``/``logaddexp2``, whose results cancel to near zero, also atol
1e-6 (a few ulp of their inputs, which are of order 1); reductions and
norms of float32 data rtol 1e-5 (sums in another order).
Values, dtype, ``gshape``, ``split`` and ``lshape_map`` are compared.
"""
import builtins
import types

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

ELEMENTWISE_RTOL = 1e-6
CANCELLING_ATOL = 1e-6
REDUCTION_RTOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_self():
    """The port on the CPU, heat_tpu on a 1-device communicator."""
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _same(t, j, rtol=ELEMENTWISE_RTOL, atol=0.0):
    """Values, dtype, gshape, split and lshape_map of a port result ``t``
    and a heat_tpu result ``j``; exact for bool and integer types."""
    assert isinstance(t, htt.DNDarray) and isinstance(j, htj.DNDarray), (type(t), type(j))
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape)
    assert t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    tn, jn = t.numpy(), np.asarray(j.numpy())
    if tn.dtype.kind in "biu":
        np.testing.assert_array_equal(tn, jn)
    else:
        np.testing.assert_allclose(tn, jn, rtol=rtol, atol=atol, equal_nan=True)
        np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))


def _both(a, split=0):
    return htt.array(a, split=split), htj.array(a, split=split)


_rng = np.random.default_rng(2026)
SHAPE = (7, 5)
DOMAINS = {
    "any": (_rng.normal(size=SHAPE) * 2).astype(np.float32),
    "pos": _rng.uniform(0.1, 4.0, size=SHAPE).astype(np.float32),
    "unit": _rng.uniform(-0.9, 0.9, size=SHAPE).astype(np.float32),
    "ge1": _rng.uniform(1.1, 4.0, size=SHAPE).astype(np.float32),
    # NaN, infinities and signed zeros among ordinary values
    "special": np.array(
        [[np.nan, np.inf, -np.inf, -0.0, 0.0], [1.5, -2.5, 0.5, -0.5, 2.5]] + [[1.25, -3.0, 4.0, -7.5, 0.1]] * 5,
        np.float32,
    ),
}
INTS = _rng.integers(1, 7, size=SHAPE)


# ----------------------------------------------------------- unary functions
UNARY = {
    # exponential
    "exp": "any", "expm1": "any", "exp2": "any", "log": "pos", "log2": "pos", "log10": "pos",
    "log1p": "pos", "sqrt": "pos", "rsqrt": "pos", "square": "any", "cbrt": "any",
    # trigonometrics
    "acos": "unit", "arccos": "unit", "acosh": "ge1", "arccosh": "ge1", "asin": "unit", "arcsin": "unit",
    "asinh": "any", "arcsinh": "any", "atan": "any", "arctan": "any", "atanh": "unit", "arctanh": "unit",
    "cos": "any", "cosh": "any", "deg2rad": "any", "radians": "any", "rad2deg": "any", "degrees": "any",
    "sin": "any", "sinc": "any", "sinh": "any", "tan": "unit", "tanh": "any",
    # rounding
    "abs": "any", "absolute": "any", "ceil": "any", "floor": "any", "trunc": "any", "fabs": "any",
    "round": "any", "sign": "any", "sgn": "any", "nan_to_num": "special",
    # logical
    "isfinite": "special", "isinf": "special", "isnan": "special", "isneginf": "special",
    "isposinf": "special", "signbit": "special", "logical_not": "special",
    # arithmetic
    "neg": "any", "negative": "any", "pos": "any", "positive": "any",
}
# functions whose integer input is computed in float (int32 -> float32,
# int64 -> float64) or kept, as heat_tpu decides per function
UNARY_INT = sorted(set(UNARY) - {"acos", "arccos", "asin", "arcsin", "atanh", "arctanh", "acosh", "arccosh", "sinc"})


@pytest.mark.parametrize("name", sorted(UNARY))
@pytest.mark.parametrize("split", [0, 1])
def test_unary_float32(name, split):
    t, j = _both(DOMAINS[UNARY[name]], split)
    _same(getattr(htt, name)(t), getattr(htj, name)(j))


@pytest.mark.parametrize("name", UNARY_INT)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_unary_int(name, dtype):
    t, j = _both(INTS.astype(dtype) * np.array([1, -1, 1, -1, 1], dtype), None)
    if name in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt"):
        t, j = _both(INTS.astype(dtype), None)
    _same(getattr(htt, name)(t), getattr(htj, name)(j))


@pytest.mark.parametrize("name", ["abs", "square", "isnan", "logical_not", "pos", "nan_to_num"])
def test_unary_bool(name):
    t, j = _both(DOMAINS["any"] > 0)
    _same(getattr(htt, name)(t), getattr(htj, name)(j))


@pytest.mark.parametrize("name", ["neg", "sign"])
def test_unary_bool_raises(name):
    t, j = _both(DOMAINS["any"] > 0)
    with pytest.raises(TypeError):
        getattr(htj, name)(j)
    with pytest.raises(TypeError):
        getattr(htt, name)(t)


def test_unary_out_and_dtype_arguments():
    a = DOMAINS["any"]
    t, j = _both(a)
    ot, oj = htt.zeros(SHAPE, split=0), htj.zeros(SHAPE, split=0)
    assert htt.exp(t, out=ot) is ot and htj.exp(j, out=oj) is oj
    _same(ot, oj)
    _same(htt.abs(t, dtype=htt.int32), htj.abs(j, dtype=htj.int32))
    _same(htt.round(t, 1), htj.round(j, 1))
    _same(htt.round(t, dtype=htt.int64), htj.round(j, dtype=htj.int64))
    st, sj = _both(DOMAINS["special"])
    _same(htt.nan_to_num(st, nan=-1.0, posinf=9.0), htj.nan_to_num(sj, nan=-1.0, posinf=9.0))
    for kt, kj in zip(htt.modf(t), htj.modf(j)):
        _same(kt, kj)


@pytest.mark.parametrize(
    "bounds", [(-1.0, 2.0), (None, 0.5), (-0.5, None), (2.0, -1.0), "arrays"], ids=["both", "hi", "lo", "crossed", "arrays"]
)
def test_clip(bounds):
    t, j = _both(DOMAINS["any"])
    if bounds == "arrays":
        lo = np.full(SHAPE[1], -1.0, np.float32)
        hi = np.linspace(0, 2, SHAPE[1]).astype(np.float32)
        _same(htt.clip(t, htt.array(lo), htt.array(hi)), htj.clip(j, htj.array(lo), htj.array(hi)))
        return
    _same(htt.clip(t, *bounds), htj.clip(j, *bounds))


@pytest.mark.parametrize("bounds", [(-3, 2), (-3.5, 2)], ids=["int", "float"])
def test_clip_int_input(bounds):
    t, j = _both(INTS.astype(np.int32) - 4)
    _same(htt.clip(t, *bounds), htj.clip(j, *bounds))


def test_clip_needs_a_bound():
    for mod, x in zip((htt, htj), _both(DOMAINS["any"])):
        with pytest.raises(ValueError):
            mod.clip(x)


# ---------------------------------------------------------- binary functions
BINARY = {
    # name: (domain of x1, domain of x2)
    "add": ("any", "any"), "sub": ("any", "any"), "subtract": ("any", "any"), "mul": ("any", "any"),
    "multiply": ("any", "any"), "div": ("any", "pos"), "divide": ("any", "pos"), "pow": ("pos", "any"),
    "power": ("pos", "any"), "floordiv": ("any", "divisor"), "floor_divide": ("any", "divisor"),
    "mod": ("any", "divisor"), "remainder": ("any", "divisor"), "fmod": ("any", "divisor"),
    "hypot": ("any", "any"), "copysign": ("any", "any"), "logaddexp": ("any", "any"),
    "logaddexp2": ("any", "any"), "atan2": ("any", "any"), "arctan2": ("any", "any"),
    "maximum": ("special", "any"), "minimum": ("special", "any"),
    "logical_and": ("special", "any"), "logical_or": ("special", "any"), "logical_xor": ("special", "any"),
    "isclose": ("any", "near"),
    "eq": ("ints_f", "ints_f"), "ne": ("ints_f", "ints_f"), "lt": ("ints_f", "ints_f"),
    "le": ("ints_f", "ints_f"), "gt": ("ints_f", "ints_f"), "ge": ("ints_f", "ints_f"),
    "not_equal": ("ints_f", "ints_f"), "less": ("ints_f", "ints_f"),
    "less_equal": ("ints_f", "ints_f"), "greater": ("ints_f", "ints_f"), "greater_equal": ("ints_f", "ints_f"),
}
DOMAINS["divisor"] = (_rng.uniform(0.5, 3.0, size=SHAPE) * _rng.choice([-1, 1], size=SHAPE)).astype(np.float32)
DOMAINS["near"] = DOMAINS["any"] + np.where(_rng.random(SHAPE) < 0.5, 1e-6, 1e-2).astype(np.float32) * DOMAINS["any"]
DOMAINS["ints_f"] = _rng.integers(-2, 3, size=SHAPE).astype(np.float32)


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("form", ["arrays", "broadcast_row", "scalar_right", "scalar_left"])
def test_binary_float32(name, form):
    d1, d2 = BINARY[name]
    a, b = DOMAINS[d1], DOMAINS[d2]
    ta, ja = _both(a)
    if form == "arrays":
        tb, jb = _both(b)
    elif form == "broadcast_row":
        tb, jb = _both(b[0], None)
    elif form == "scalar_right":
        tb = jb = builtins.float(b[0, 1])
    else:
        ta = ja = builtins.float(a[0, 1])
        tb, jb = _both(b)
    atol = CANCELLING_ATOL if name in ("logaddexp", "logaddexp2") else 0.0
    _same(getattr(htt, name)(ta, tb), getattr(htj, name)(ja, jb), atol=atol)


INT_BINARY = ["add", "sub", "mul", "floordiv", "mod", "fmod", "pow", "maximum", "minimum", "hypot", "copysign",
              "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift", "right_shift", "eq", "lt", "ge",
              "logical_and", "logical_xor", "isclose"]


@pytest.mark.parametrize("name", INT_BINARY)
@pytest.mark.parametrize("dtypes", [(np.int32, np.int32), (np.int64, np.int32), (np.int32, "scalar")])
def test_binary_int(name, dtypes):
    a = (INTS * np.array([1, -1, 1, -1, 1])).astype(dtypes[0])
    b = _rng.integers(1, 4, size=SHAPE)  # positive: divisors, shift counts and exponents
    ta, ja = _both(a)
    if dtypes[1] == "scalar":
        tb = jb = 3
    else:
        tb, jb = _both(b.astype(dtypes[1]))
    _same(getattr(htt, name)(ta, tb), getattr(htj, name)(ja, jb))


@pytest.mark.parametrize("name", ["bitwise_and", "bitwise_or", "bitwise_xor", "left_shift", "right_shift",
                                  "logical_and", "logical_or", "logical_xor", "eq", "ne", "add", "mul"])
@pytest.mark.parametrize("other", ["bool", "int_scalar"])
def test_binary_bool(name, other):
    a = DOMAINS["any"] > 0
    ta, ja = _both(a)
    if other == "bool":
        tb, jb = _both(DOMAINS["pos"] > 2)
    else:
        tb = jb = 1
    _same(getattr(htt, name)(ta, tb), getattr(htj, name)(ja, jb))


@pytest.mark.parametrize("name", ["bitwise_and", "bitwise_or", "bitwise_xor", "left_shift", "right_shift", "invert"])
def test_bitwise_rejects_float(name):
    ti, ji = _both(INTS.astype(np.int32))
    tf, jf = _both(DOMAINS["any"])
    for mod, i, f in ((htt, ti, tf), (htj, ji, jf)):
        fn = getattr(mod, name)
        with pytest.raises(TypeError):
            fn(f) if name == "invert" else fn(f, i)
        if name != "invert":
            with pytest.raises(TypeError):
                fn(i, 1.5)


@pytest.mark.parametrize("name", ["invert", "bitwise_not"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_invert(name, dtype):
    t, j = _both((INTS - 3).astype(dtype))
    _same(getattr(htt, name)(t), getattr(htj, name)(j))


def test_pow_negative_integer_scalar_raises():
    """An integer base with a negative integer scalar exponent raises
    TypeError in both packages, before the op runs."""
    for dtype, e in ((np.int32, -2), (np.int64, -1), (np.int32, np.int64(-3)), (np.bool_, -1)):
        t, j = _both(np.array([2, 3, -4]).astype(dtype))
        for x in (t, j):
            with pytest.raises(TypeError, match="negative powers"):
                x ** e
        with pytest.raises(TypeError, match="negative powers"):
            htt.pow(t, e)
        with pytest.raises(TypeError, match="negative powers"):
            htt.power(t, e)
    # a float exponent, or a float base, is fine
    t, j = _both(np.array([2, 3, -4], np.int32))
    _same(t ** -2.0, j ** -2.0)
    tf, jf = _both(np.array([2.0, 3.0, -4.0], np.float32))
    _same(tf ** -2, jf ** -2)


def test_pow_integer_array_exponent():
    """heat_tpu's answer for negative entries of an integer array exponent
    is undefined: only the non-negative entries are compared."""
    base = np.array([2, 3, -4, 5], np.int32)
    expo = np.array([3, -1, 2, 0], np.int32)
    r_t = htt.pow(htt.array(base), htt.array(expo))
    r_j = htj.pow(htj.array(base), htj.array(expo))
    assert r_t.dtype is htt.int32 and r_j.dtype is htj.int32
    keep = expo >= 0
    np.testing.assert_array_equal(r_t.numpy()[keep], np.asarray(r_j.numpy())[keep])
    np.testing.assert_array_equal(r_t.numpy()[keep], base[keep] ** expo[keep])


# -------------------------------------------------------------- relational
@pytest.mark.parametrize("op", ["__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("other", ["array", "row", "scalar", "int_array"])
def test_relational_dunders(op, split, other):
    """C2: the six comparisons give bool DNDarrays with the operands'
    split, never a python bool."""
    a = DOMAINS["ints_f"]
    t, j = _both(a, split)
    if other == "array":
        ot, oj = _both(np.roll(a, 1, axis=1), split)
    elif other == "row":
        ot, oj = _both(a[2], None)
    elif other == "int_array":
        ot, oj = _both(a.astype(np.int32), split)
    else:
        ot = oj = 0
    rt, rj = getattr(t, op)(ot), getattr(j, op)(oj)
    assert rt.dtype is htt.bool
    _same(rt, rj)


def test_relational_results_are_arrays_and_unhashable():
    t, j = _both(np.zeros(3, np.int32))
    assert isinstance(t == 0, htt.DNDarray) and isinstance(t != t, htt.DNDarray)
    np.testing.assert_array_equal((t == 0).numpy(), [True, True, True])
    np.testing.assert_array_equal((t != t).numpy(), [False, False, False])
    for x in (t, j):
        with pytest.raises(TypeError):
            hash(x)
        with pytest.raises(TypeError):
            {x}


@pytest.mark.parametrize(
    "case", ["same", "different", "broadcast_equal", "shape_mismatch", "scalar"],
)
def test_equal(case):
    a = DOMAINS["ints_f"]
    t, j = _both(a)
    if case == "same":
        ot, oj = _both(a.copy())
    elif case == "different":
        b = a.copy()
        b[3, 3] += 1
        ot, oj = _both(b)
    elif case == "broadcast_equal":
        t, j = _both(np.tile(a[0], (4, 1)))
        ot, oj = _both(a[0], None)
    elif case == "shape_mismatch":
        ot, oj = _both(np.zeros((2, 2), np.float32))
    else:
        t, j = _both(np.full(SHAPE, 2.0, np.float32))
        ot = oj = 2
    rt, rj = htt.equal(t, ot), htj.equal(j, oj)
    assert type(rt) is bool and rt == rj


@pytest.mark.parametrize("kwargs", [{}, {"rtol": 1e-3}, {"atol": 1e-1}, {"equal_nan": True}])
def test_isclose_allclose(kwargs):
    a = DOMAINS["special"]
    b = a * (1 + 1e-4)
    t, j = _both(a)
    tb, jb = _both(b)
    _same(htt.isclose(t, tb, **kwargs), htj.isclose(j, jb, **kwargs))
    assert htt.allclose(t, tb, **kwargs) == htj.allclose(j, jb, **kwargs)
    assert htt.allclose(t, t, equal_nan=True) and htj.allclose(j, j, equal_nan=True)
    _same(t.isclose(tb, **kwargs), j.isclose(jb, **kwargs))


# -------------------------------------------------------------- reductions
REDUCE_DATA = {
    "float": DOMAINS["any"],
    "nan": np.where(_rng.random(SHAPE) < 0.2, np.nan, DOMAINS["any"]).astype(np.float32),
    "int": (INTS * np.array([1, -1, 1, -1, 1])).astype(np.int32),
    "ties": _rng.integers(0, 2, size=SHAPE).astype(np.float32),
    "bool": DOMAINS["any"] > 0,
}
REDUCE_DATA["nan"][:, 2] = np.nan  # a whole all-NaN column


REDUCTIONS = ["min", "max", "nanmin", "nanmax", "argmin", "argmax", "all", "any", "nansum", "nanprod"]


@pytest.mark.parametrize(
    "name,data",
    # jnp.nanmin/nanmax take no bool input
    [(n, d) for n in REDUCTIONS for d in sorted(REDUCE_DATA) if not (d == "bool" and n in ("nanmin", "nanmax"))],
)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions(name, data, axis):
    a = REDUCE_DATA[data]
    t, j = _both(a, 0)
    _same(getattr(htt, name)(t, axis=axis), getattr(htj, name)(j, axis=axis), rtol=REDUCTION_RTOL)


@pytest.mark.parametrize("name", ["min", "max", "nanmin", "nanmax", "all", "any", "nansum", "nanprod"])
@pytest.mark.parametrize("axis", [None, 1, (0, 1)])
def test_reductions_keepdims_split1(name, axis):
    t, j = _both(REDUCE_DATA["nan"], 1)
    _same(getattr(htt, name)(t, axis=axis, keepdims=True), getattr(htj, name)(j, axis=axis, keepdims=True),
          rtol=REDUCTION_RTOL)


def test_arg_reductions_take_the_first_tie_and_nan():
    a = np.array([[1.0, 3.0, 3.0, 0.0], [np.nan, 2.0, np.nan, -1.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    t, j = _both(a)
    for name in ("argmin", "argmax"):
        for axis in (None, 0, 1):
            rt = getattr(htt, name)(t, axis=axis)
            assert rt.dtype is htt.int64
            _same(rt, getattr(htj, name)(j, axis=axis))
    np.testing.assert_array_equal(htt.argmax(t, axis=1).numpy(), [1, 0, 0])


@pytest.mark.parametrize("name", ["minimum", "maximum"])
def test_minimum_maximum_propagate_nan(name):
    t, j = _both(REDUCE_DATA["nan"])
    tb, jb = _both(DOMAINS["any"])
    _same(getattr(htt, name)(t, tb), getattr(htj, name)(j, jb))


@pytest.mark.parametrize("name", ["cumsum", "cumprod", "cumproduct"])
@pytest.mark.parametrize("data", ["float", "int", "bool"])
@pytest.mark.parametrize("axis", [0, 1])
def test_cumulative(name, data, axis):
    a = REDUCE_DATA[data] if data != "float" else DOMAINS["unit"]
    t, j = _both(a)
    _same(getattr(htt, name)(t, axis), getattr(htj, name)(j, axis), rtol=REDUCTION_RTOL)


def test_cumsum_dtype_and_method():
    t, j = _both(DOMAINS["unit"])
    _same(htt.cumsum(t, 0, dtype=htt.float64), htj.cumsum(j, 0, dtype=htj.float64))
    _same(t.cumsum(1), j.cumsum(1), rtol=REDUCTION_RTOL)
    _same(t.cumprod(0), j.cumprod(0), rtol=REDUCTION_RTOL)
    for mod, x in ((htt, t), (htj, j)):
        with pytest.raises(NotImplementedError):
            mod.cumsum(x, None)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"n": 2}, {"axis": 0}, {"prepend": 0.5}, {"append": "array"}, {"n": 0}],
    ids=["default", "n2", "axis0", "prepend", "append", "n0"],
)
@pytest.mark.parametrize("data", ["float", "int", "bool"])
def test_diff(kwargs, data):
    a = REDUCE_DATA[data]
    t, j = _both(a)
    kt, kj = dict(kwargs), dict(kwargs)
    if kwargs.get("append") == "array":
        e = np.ones((SHAPE[0], 1), a.dtype)
        kt["append"], kj["append"] = htt.array(e), htj.array(e)
    _same(htt.diff(t, **kt), htj.diff(j, **kj))
    with pytest.raises(ValueError):
        htt.diff(t, n=-1)


# ----------------------------------------------------------- where/nonzero
@pytest.mark.parametrize(
    "xy", ["arrays", "scalar_x", "scalar_y", "scalars", "int_scalars", "int_float", "int64_int32"],
)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_where(xy, split):
    cond = DOMAINS["any"] > 0
    ct, cj = _both(cond, split)
    f = DOMAINS["unit"]
    i32 = INTS.astype(np.int32)
    pairs = {
        "arrays": (f, f * 2), "scalar_x": (0.0, f), "scalar_y": (f, 1.5), "scalars": (1, 0.5),
        "int_scalars": (1, 0), "int_float": (i32, 0.5), "int64_int32": (INTS.astype(np.int64), i32),
    }
    x, y = pairs[xy]
    xt, xj = _both(x, split) if isinstance(x, np.ndarray) else (x, x)
    yt, yj = _both(y, None) if isinstance(y, np.ndarray) else (y, y)
    _same(htt.where(ct, xt, yt), htj.where(cj, xj, yj))


def test_where_argument_errors():
    for mod, c in zip((htt, htj), _both(DOMAINS["any"] > 0)):
        with pytest.raises(TypeError):
            mod.where(c, 1.0)


@pytest.mark.parametrize("shape", [(7, 5), (11,), (2, 3, 4)])
@pytest.mark.parametrize("split", [None, 0])
def test_nonzero(shape, split):
    a = (_rng.random(shape) < 0.4).astype(np.float32)
    t, j = _both(a, split)
    _same(htt.nonzero(t), htj.nonzero(j))
    _same(htt.where(t), htj.where(j))
    _same(t.nonzero(), j.nonzero())


# ------------------------------------------------------- dunders, methods
DUNDERS = {
    "floordiv": lambda x, y, i: x // 2,
    "rfloordiv": lambda x, y, i: 7 // y,
    "mod": lambda x, y, i: x % 1.5,
    "rmod": lambda x, y, i: 5 % y,
    "abs": lambda x, y, i: abs(x),
    "neg": lambda x, y, i: -x,
    "pos": lambda x, y, i: +x,
    "invert": lambda x, y, i: ~i,
    "and": lambda x, y, i: i & 6,
    "or": lambda x, y, i: i | 1,
    "xor": lambda x, y, i: i ^ i,
    "lshift": lambda x, y, i: i << 2,
    "rshift": lambda x, y, i: i >> 1,
    "pow": lambda x, y, i: x ** 2,
    "rpow": lambda x, y, i: 2 ** i,
    "truediv": lambda x, y, i: x / y,
    "mask": lambda x, y, i: (x > 0) & (y < 2),
}


@pytest.mark.parametrize("name", sorted(DUNDERS))
def test_dunders(name):
    x, y, i = DOMAINS["any"], DOMAINS["pos"], (INTS - 3).astype(np.int32)
    (xt, xj), (yt, yj), (it, ij) = _both(x), _both(y), _both(i)
    _same(DUNDERS[name](xt, yt, it), DUNDERS[name](xj, yj, ij))


def test_pos_is_a_copy():
    t = htt.array(np.arange(3.0, dtype=np.float32))
    p = +t
    p.larray.add_(1)
    np.testing.assert_array_equal(t.numpy(), [0, 1, 2])


def test_scalar_conversion_len_iter_array():
    for mod in (htt, htj):
        one = mod.array(np.array([[2.5]], np.float32))
        assert float(one) == 2.5 and int(one) == 2 and bool(one) is True and complex(one) == 2.5
        assert bool(mod.array(np.array([0], np.int32))) is False
        x = mod.array(DOMAINS["any"], split=0)
        assert len(x) == SHAPE[0]
        rows = list(x)
        assert len(rows) == SHAPE[0] and rows[3].shape == (SHAPE[1],)
        np.testing.assert_array_equal(rows[3].numpy(), DOMAINS["any"][3])
        np.testing.assert_array_equal(np.asarray(x), DOMAINS["any"])
        assert np.asarray(x, dtype=np.float64).dtype == np.float64
        assert x.tolist() == DOMAINS["any"].tolist()
        with pytest.raises(TypeError):
            float(x)
        with pytest.raises(TypeError):
            len(mod.array(np.float32(1.0)))


METHODS = {
    "sum": lambda x: x.sum(), "sum_axis": lambda x: x.sum(axis=0, keepdims=True), "prod": lambda x: x.prod(axis=1),
    "mean": lambda x: x.mean(axis=0), "std": lambda x: x.std(axis=0), "var": lambda x: x.var(),
    "min": lambda x: x.min(), "max": lambda x: x.max(axis=1), "argmin": lambda x: x.argmin(axis=0),
    "argmax": lambda x: x.argmax(), "all": lambda x: (x > -100).all(axis=1), "any": lambda x: (x > 3).any(),
    "abs": lambda x: x.abs(), "ceil": lambda x: x.ceil(), "floor": lambda x: x.floor(),
    "round": lambda x: x.round(1), "trunc": lambda x: x.trunc(), "clip": lambda x: x.clip(-1, 1),
    "exp": lambda x: x.exp(), "log": lambda x: x.abs().log(), "sqrt": lambda x: x.abs().sqrt(),
    "sin": lambda x: x.sin(), "cos": lambda x: x.cos(), "tan": lambda x: x.tan(), "tanh": lambda x: x.tanh(),
    "copy": lambda x: x.copy(), "transpose": lambda x: x.transpose(), "tril": lambda x: x.tril(),
    "triu": lambda x: x.triu(1),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_methods(name):
    t, j = _both(DOMAINS["any"])
    _same(METHODS[name](t), METHODS[name](j), rtol=REDUCTION_RTOL)


@pytest.mark.parametrize("fn", ["copy", "method"])
def test_copy_does_not_alias(fn):
    a = DOMAINS["any"]
    t, j = _both(a, 1)
    ct = htt.copy(t) if fn == "copy" else t.copy()
    _same(ct, htj.copy(j))
    ct.larray.zero_()
    np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(TypeError):
        htt.copy(a)
    assert htt.sanitize_memory_layout(t, "F") is t
    with pytest.raises(ValueError):
        htt.sanitize_memory_layout(t, "K")


# ------------------------------------------------------- linalg basics
@pytest.mark.parametrize("name", ["tril", "triu"])
@pytest.mark.parametrize("k", [0, 1, -2])
@pytest.mark.parametrize("shape_split", [((7, 5), 0), ((7, 5), 1), ((6,), 0), ((2, 4, 4), None)])
def test_tril_triu(name, k, shape_split):
    shape, split = shape_split
    a = _rng.normal(size=shape).astype(np.float32)
    t, j = _both(a, split)
    _same(getattr(htt, name)(t, k), getattr(htj, name)(j, k))
    _same(getattr(htt.linalg, name)(t, k), getattr(htj.linalg, name)(j, k))


@pytest.mark.parametrize("ord", [None, "fro", 1, -1, np.inf, -np.inf, 2, -2, "nuc"])
@pytest.mark.parametrize("axis_keep", [(None, False), ((0, 1), True), ((1, 0), False)])
def test_matrix_norm(ord, axis_keep):
    axis, keep = axis_keep
    t, j = _both(DOMAINS["any"])
    _same(htt.linalg.matrix_norm(t, axis=axis, keepdims=keep, ord=ord),
          htj.linalg.matrix_norm(j, axis=axis, keepdims=keep, ord=ord), rtol=REDUCTION_RTOL)


@pytest.mark.parametrize("ord", [None, 1, 3, np.inf, -np.inf, 0])
@pytest.mark.parametrize("axis_keep", [(None, False), (0, False), (1, True), (None, True)])
def test_vector_norm(ord, axis_keep):
    axis, keep = axis_keep
    t, j = _both(DOMAINS["any"])
    _same(htt.linalg.vector_norm(t, axis=axis, keepdims=keep, ord=ord),
          htj.linalg.vector_norm(j, axis=axis, keepdims=keep, ord=ord), rtol=REDUCTION_RTOL)


@pytest.mark.parametrize(
    "case", ["default", "int", "int64", "vector_ord", "matrix_ord", "axis_int", "axis_pair", "1d"],
)
def test_norm(case):
    a = DOMAINS["any"]
    kwargs = {"vector_ord": {"ord": 1}, "matrix_ord": {"ord": "fro"}, "axis_int": {"axis": 1},
              "axis_pair": {"axis": (1, 0), "ord": np.inf}, "int64": {"axis": 0}}.get(case, {})
    if case in ("int", "int64"):
        a = INTS.astype(np.int32 if case == "int" else np.int64)
    if case in ("1d", "vector_ord"):
        a = a[2]
    t, j = _both(a)
    _same(htt.linalg.norm(t, **kwargs), htj.linalg.norm(j, **kwargs), rtol=REDUCTION_RTOL)
    _same(htt.norm(t, **kwargs), htj.norm(j, **kwargs), rtol=REDUCTION_RTOL)
    with pytest.raises(TypeError):
        htt.linalg.norm(t, axis=[0, 1, 2])


@pytest.mark.parametrize("case", ["vectors", "int_vectors", "bool_vectors", "mixed_vectors", "matrix_vector",
                                  "matrices"])
def test_dot(case):
    a, b = DOMAINS["any"][0], DOMAINS["pos"][1]
    if case == "int_vectors":
        a, b = INTS[0].astype(np.int32), INTS[1].astype(np.int32)
    elif case == "bool_vectors":
        a, b = DOMAINS["any"][0] > 0, DOMAINS["any"][1] > 0
    elif case == "mixed_vectors":
        a = INTS[0].astype(np.int32)
    elif case == "matrix_vector":
        a = DOMAINS["any"]
    elif case == "matrices":
        a, b = DOMAINS["any"], DOMAINS["pos"].T.copy()
    (ta, ja), (tb, jb) = _both(a), _both(b, None)
    _same(htt.dot(ta, tb), htj.dot(ja, jb), rtol=REDUCTION_RTOL)
    _same(htt.linalg.dot(ta, tb), htj.linalg.dot(ja, jb), rtol=REDUCTION_RTOL)


@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0), ("explicit", None)])
def test_outer(splits):
    a, b = DOMAINS["any"][0], INTS[1].astype(np.int32)
    kw = {}
    if splits[0] == "explicit":
        splits, kw = (None, None), {"split": 1}
    (ta, ja), (tb, jb) = _both(a, splits[0]), _both(b, splits[1])
    _same(htt.outer(ta, tb, **kw), htj.outer(ja, jb, **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("offset", [0, 1, -2])
def test_trace(dtype, offset):
    a = (DOMAINS["any"] * 3).astype(dtype)
    t, j = _both(a)
    _same(htt.trace(t, offset), htj.trace(j, offset), rtol=REDUCTION_RTOL)
    _same(htt.linalg.trace(t, offset, dtype=htt.float64), htj.linalg.trace(j, offset, dtype=htj.float64))


# --------------------------------------------------------- what is missing
MODULES = ["relational", "exponential", "trigonometrics", "rounding", "logical", "indexing", "memory"]
EXTREMA = ["min", "max", "argmin", "argmax", "minimum", "maximum", "nanmin", "nanmax"]


def test_every_name_of_the_slice_is_exported_and_covered():
    """Every name of the slice's modules exists in the port, and one of
    this file's parity tables drives it."""
    from heat_tpu.core import arithmetics as j_arith

    names = set(EXTREMA) | set(j_arith.__all__)
    for m in MODULES:
        names |= set(getattr(htj.core, m).__all__)
    assert not sorted(n for n in names if not hasattr(htt, n))
    covered = (set(UNARY) | set(BINARY) | set(INT_BINARY) | {"equal", "allclose", "clip", "modf", "all", "any",
               "where", "nonzero", "copy", "sanitize_memory_layout", "invert", "bitwise_not", "cumsum",
               "cumprod", "cumproduct", "diff", "sum", "prod", "nansum", "nanprod", "bitwise_or"} | set(EXTREMA))
    assert not sorted(names - covered)
    for name in ("tril", "triu", "norm", "vector_norm", "matrix_norm", "dot", "outer", "trace", "qr"):
        assert hasattr(htt.linalg, name)


# Public names heat_tpu exports that the port does not yet, submodules apart
# (which submodules are attributes of a package depends on what the process
# imported before). Later slices shrink these lists; a name the port gains
# must leave them.
STILL_MISSING = {
    # the lazy layer and analysis came with ROADMAP.md, Queue A item 12, the last: the port has every name
    "heat_tpu": [],
    "heat_tpu.linalg": [],
    # DNDarray's members: every one (health_check came with resilience.validate, Queue A item 10a)
    "DNDarray": [],
    # the port's parallel package has every name (ROADMAP.md, Queue A item 6)
    "heat_tpu.parallel": [],
    # StreamingGroupBy came with frame (ROADMAP.md, Queue A item 9)
    "heat_tpu.stream": [],
    "heat_tpu.frame": [],
    # degrade, supervisor and monitor came with ROADMAP.md, Queue A item 10b
    "heat_tpu.resilience": [],
    # the serving layer (ROADMAP.md, Queue A item 11) has every name
    "heat_tpu.serve": [],
    # the ML long tail and the training path have every name (ROADMAP.md, Queue A items 7 and 8)
    "heat_tpu.naive_bayes": [],
    "heat_tpu.nn": [],
    "heat_tpu.optim": [],
    "heat_tpu.regression": [],
    "heat_tpu.utils": [],
}
# submodules heat_tpu imports when it is imported, and the port has no counterpart of yet
STILL_MISSING_MODULES = []
# submodules the port has, ported by later slices than the array surface
PORTED_MODULES = ["naive_bayes", "nn", "optim", "regression", "utils", "datasets", "frame", "resilience", "serve",
                  "analysis", "testing"]
# heat_tpu's modules that have no counterpart in the port, and why
NO_COUNTERPART = {
    # XLA-CPU's fence against collective programs in flight; torch ops on a stream run in order, and gloo's
    # collectives are synchronous
    "core/_dispatch.py",
    # shims between jax versions: no meaning outside JAX
    "core/_jax_compat.py",
}


@pytest.mark.parametrize("module", sorted(STILL_MISSING))
def test_names_the_port_still_lacks(module):
    def pub(m):
        return {n for n in dir(m) if not n.startswith("_") and not isinstance(getattr(m, n), types.ModuleType)}

    leaf = module.rpartition(".")[2]
    ref, port = (htj, htt) if module == "heat_tpu" else (getattr(htj, leaf), getattr(htt, leaf))
    assert sorted(pub(ref) - pub(port)) == sorted(STILL_MISSING[module])


def test_every_module_has_a_counterpart():
    import os

    def files(root):
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py")}

    ref_root, port_root = os.path.dirname(htj.__file__), os.path.dirname(htt.__file__)
    assert sorted(files(ref_root) - files(port_root)) == sorted(NO_COUNTERPART)


def test_modules_the_port_still_lacks():
    for name in STILL_MISSING_MODULES:
        parent, _, leaf = name.rpartition(".")
        ref, port = (htj.linalg, htt.linalg) if parent else (htj, htt)
        assert isinstance(getattr(ref, leaf), types.ModuleType), name
        assert not hasattr(port, leaf), name
    for name in MODULES + ["arithmetics", "statistics", "linalg", "manipulations", "parallel"] + PORTED_MODULES:
        assert isinstance(getattr(htt, name), types.ModuleType), name
