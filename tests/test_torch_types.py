"""heat_tpu_torch's type system and the new types through the array
surface, against heat_tpu, on the CPU.

The twelve concrete types (bool, uint8, int8, int16, int32, int64,
float16, bfloat16, float32, float64, complex64, complex128): every pair
under ``promote_types``, every pair under each of the five ``can_cast``
rules, the scalar rules of mixed operations, ``result_type``,
``heat_type_of``, ``issubdtype``, ``finfo``/``iinfo``, the factories'
inference and ``dtype=``, ``astype`` and ``numpy()`` (bfloat16 comes back
as float32, which holds it exactly; heat_tpu's ``ml_dtypes`` array is
widened the same way to compare), ``convert.array_from_numpy``, and the
elementwise functions and reductions over the small, half and complex
types. heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the
port does; values, dtype, ``gshape``, ``split`` and ``lshape_map`` are
compared.

Tolerances: bool and integer results exact; float32/float64/complex
results rtol 1e-6 (a few ulp: XLA's and torch's functions round
otherwise in the last bits); float16 and bfloat16 results within four
units of the type's unit roundoff (4 * 2^-11 and 4 * 2^-8): torch
computes a half-precision function in float32 and rounds once, XLA's
half-precision functions are not correctly rounded. Sums and means of
half data accumulate in float32 on both sides and round once; products
of half data round at every factor in jnp, so ``prod`` of the 20 values
is held within 20 such roundings.
"""
import builtins

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

TYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64",
         "complex64", "complex128"]
RULES = ["no", "safe", "same_kind", "unsafe", "intuitive"]
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
    """heat_tpu's numpy() with bfloat16 widened to float32."""
    a = np.asarray(j.numpy())
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same(t, j, rtol=None):
    assert isinstance(t, htt.DNDarray) and isinstance(j, htj.DNDarray), (type(t), type(j))
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    tn, jn = t.numpy(), _host(j)
    if tn.dtype.kind in "biu":
        np.testing.assert_array_equal(tn, jn)
        return
    rtol = HALF_RTOL.get(t.dtype.__name__, RTOL) if rtol is None else rtol
    scale = np.nanmax(np.abs(jn)) if jn.size and not np.isnan(jn).all() else 0.0
    np.testing.assert_allclose(tn, jn, rtol=rtol, atol=rtol * scale * 1e-3, equal_nan=True)


def _both(a, split=0, dtype=None):
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    if dtype is not None:
        t, j = t.astype(getattr(htt, dtype)), j.astype(getattr(htj, dtype))
    return t, j


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("b", TYPES)
@pytest.mark.parametrize("a", TYPES)
def test_promote_types(a, b):
    assert htt.promote_types(getattr(htt, a), getattr(htt, b)).__name__ == \
        htj.promote_types(getattr(htj, a), getattr(htj, b)).__name__


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("b", TYPES)
@pytest.mark.parametrize("a", TYPES)
def test_can_cast(a, b, rule):
    assert htt.can_cast(getattr(htt, a), getattr(htt, b), rule) == htj.can_cast(getattr(htj, a), getattr(htj, b), rule)


@pytest.mark.parametrize("scalar", [True, 5, -300, 1.5, 2j])
@pytest.mark.parametrize("t", TYPES)
def test_can_cast_python_scalars_by_type(scalar, t):
    for rule in RULES:
        assert htt.can_cast(scalar, getattr(htt, t), rule) == htj.can_cast(scalar, getattr(htj, t), rule)


def test_can_cast_rejects_unknown_rule():
    for mod in (htt, htj):
        with pytest.raises(ValueError):
            mod.can_cast(mod.int8, mod.int16, "sideways")


@pytest.mark.parametrize("scalar", [True, 3, 300, 1.5, 1 + 2j, np.float32(2.5), np.int8(3)])
@pytest.mark.parametrize("t", TYPES)
def test_result_type_with_scalars(t, scalar):
    a = np.zeros(3, dtype=np.float32)
    tt, jj = _both(a, None, t)
    assert htt.result_type(tt, scalar).__name__ == htj.result_type(jj, scalar).__name__
    assert htt.result_type(getattr(htt, t), scalar).__name__ == htj.result_type(getattr(htj, t), scalar).__name__


@pytest.mark.parametrize("obj", [True, 3, 1.5, 1j, np.int8(1), np.float16(1), np.complex128(1), [1, 2], [1.5],
                                 np.zeros(2, np.uint8), np.zeros(2, np.int16)])
def test_heat_type_of(obj):
    assert htt.heat_type_of(obj).__name__ == htj.heat_type_of(obj).__name__


@pytest.mark.parametrize("t", TYPES)
def test_kind_predicates_and_issubdtype(t):
    tt, tj = getattr(htt, t), getattr(htj, t)
    assert htt.heat_type_is_exact(tt) == htj.heat_type_is_exact(tj)
    assert htt.heat_type_is_inexact(tt) == htj.heat_type_is_inexact(tj)
    assert htt.heat_type_is_complexfloating(tt) == htj.heat_type_is_complexfloating(tj)
    for parent in ("generic", "number", "integer", "signedinteger", "unsignedinteger", "inexact", "floating",
                   "complexfloating", "flexible"):
        assert htt.issubdtype(tt, getattr(htt.types, parent)) == htj.issubdtype(tj, getattr(htj.core.types, parent)), \
            parent


@pytest.mark.parametrize("name", ["byte", "short", "ubyte", "cfloat", "csingle", "cdouble", "int_", "float_",
                                  "bool_", "int", "long", "float", "double"])
def test_aliases(name):
    assert getattr(htt, name).__name__ == getattr(htj, name).__name__
    assert htt.half is htt.float16 and htt.complex is htt.complexfloating


@pytest.mark.parametrize("spec", ["uint8", "u1", "int8", "i1", "int16", "i2", "float16", "f2", "half", "bfloat16",
                                  "complex64", "c8", "complex128", "c16", complex, np.uint8, np.complex64, np.float16])
def test_canonical_heat_type(spec):
    assert htt.canonical_heat_type(spec).__name__ == htj.canonical_heat_type(spec).__name__
    assert htt.canonical_heat_type(htt.complex).__name__ == "complex64"


@pytest.mark.parametrize("t", ["float16", "bfloat16", "float32", "float64", "complex64", "complex128"])
def test_finfo(t):
    a, b = htt.finfo(getattr(htt, t)), htj.finfo(getattr(htj, t))
    assert (a.bits, a.eps, a.max, a.min, a.tiny) == (b.bits, b.eps, b.max, b.min, b.tiny)


@pytest.mark.parametrize("t", ["bool", "uint8", "int8", "int16", "int32", "int64"])
def test_iinfo(t):
    a, b = htt.iinfo(getattr(htt, t)), htj.iinfo(getattr(htj, t))
    assert (a.bits, a.max, a.min) == (b.bits, b.max, b.min)
    with pytest.raises(TypeError):
        htt.iinfo(htt.float16)
    with pytest.raises(TypeError):
        htt.finfo(htt.uint8)


# --------------------------------------------------- the scalar-rule table
def test_mixed_operation_rules():
    """The results ``heat_tpu`` gives to mixed operations, with values (torch
    wraps small integers as jnp does)."""
    i8 = np.array([1, 100, -3], np.int8)
    u8 = np.array([0, 200, 3], np.uint8)
    f16 = np.array([1.5, 2.0, 3.0], np.float16)
    c64 = np.array([1 + 5j, 1 + 2j, 9j], np.complex64)
    cases = [
        (lambda m: m.array(i8) + 1.5, "float32"),
        (lambda m: m.array(i8) + 300, "int8"),
        (lambda m: m.array(u8) + m.array(i8), "int16"),
        (lambda m: m.array(u8) - 1, "uint8"),
        (lambda m: m.array(c64) * 1.5, "complex64"),
        (lambda m: m.sum(m.array(u8)), "int64"),
        (lambda m: m.mean(m.array(u8)), "float32"),
        (lambda m: m.mean(m.array(f16)), "float16"),
        (lambda m: m.var(m.array(f16)), "float16"),
        (lambda m: m.abs(m.array(c64)), "float32"),
        (lambda m: m.angle(m.array(c64)), "float32"),
        (lambda m: m.var(m.array(c64)), "float32"),
        (lambda m: m.array(f16) + m.array(f16).astype(m.bfloat16), "float32"),
        (lambda m: m.array(f16) + m.array(np.array([1, 2, 3], np.int32)), "float32"),
        (lambda m: m.array(f16) * 2.5, "float16"),
        (lambda m: m.array(u8) * 2.5, "float32"),
        (lambda m: m.array(u8) / 2, "float32"),
        (lambda m: m.array(u8) // 2, "uint8"),
        (lambda m: -m.array(u8), "uint8"),
        (lambda m: m.array(i8) / m.array(np.array([1, 2, 4], np.int64)), "float64"),
    ]
    for fn, want in cases:
        t, j = fn(htt), fn(htj)
        assert t.dtype.__name__ == j.dtype.__name__ == want
        _same(t, j)


# ------------------------------------------------------ creation and round trips
HOST = {
    "bool": np.array([[True, False], [False, True], [True, True]]),
    "uint8": np.array([[0, 255], [7, 128], [1, 2]], np.uint8),
    "int8": np.array([[-128, 127], [7, -8], [1, 2]], np.int8),
    "int16": np.array([[-32768, 32767], [7, -8], [1, 2]], np.int16),
    "int32": np.array([[1, -2], [3, 4], [5, 6]], np.int32),
    "int64": np.array([[1, -2], [3, 4], [5, 2 ** 40]], np.int64),
    "float16": np.array([[1.5, -2.25], [65504, 6e-5], [0.1, 3]], np.float16),
    "float32": np.array([[1.5, -2.25], [1e30, 1e-30], [0.1, 3]], np.float32),
    "float64": np.array([[1.5, -2.25], [1e300, 1e-300], [0.1, 3]], np.float64),
    "complex64": np.array([[1 + 2j, -3j], [4, 0.5 - 0.5j], [1, 1j]], np.complex64),
    "complex128": np.array([[1 + 2j, -3j], [4, 0.5 - 0.5j], [1e200, 1j]], np.complex128),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("t", sorted(HOST))
def test_array_of_each_numpy_type(t, split):
    a = HOST[t]
    _same(htt.array(a, split=split), htj.array(a, split=split))


def test_array_of_a_numpy_bfloat16_array():
    import ml_dtypes

    a = np.array([[1.5, -2.25], [3.0e38, 1e-38]], np.float32).astype(ml_dtypes.bfloat16)
    t, j = htt.array(a, split=0), htj.array(a, split=0)
    _same(t, j)
    assert t.numpy().dtype == np.float32
    np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))  # the bits moved exactly


@pytest.mark.parametrize("t", TYPES)
def test_factories_with_dtype(t):
    for fn in (lambda m: m.zeros((3, 2), dtype=getattr(m, t), split=0),
               lambda m: m.ones((3, 2), dtype=getattr(m, t)),
               lambda m: m.full((3, 2), 1, dtype=getattr(m, t), split=1),
               lambda m: m.array([[1, 0], [2, 3]], dtype=getattr(m, t), split=0)):
        _same(fn(htt), fn(htj))
    if t not in ("bool", "complex64", "complex128"):
        _same(htt.arange(5, dtype=getattr(htt, t)), htj.arange(5, dtype=getattr(htj, t)))


@pytest.mark.parametrize("dst", TYPES)
@pytest.mark.parametrize("src", ["uint8", "int16", "float16", "bfloat16", "float32", "complex64"])
def test_astype(src, dst):
    a = np.array([[0, 1.5], [2.75, 100.25], [7, 3]], np.float32)
    t, j = _both(a, 0, src)
    if htj.heat_type_is_complexfloating(getattr(htj, src)) and not htj.heat_type_is_complexfloating(getattr(htj, dst)):
        j, t = j.astype(htj.float32), t.astype(htt.float32)  # both drop the imaginary part; compare from float32
    _same(t.astype(getattr(htt, dst)), j.astype(getattr(htj, dst)))


@pytest.mark.parametrize("t", TYPES)
def test_numpy_and_array_from_numpy_carry_heat_tpu_arrays(t):
    """A heat_tpu array of each type carried into the port through numpy()."""
    j = htj.array(HOST.get(t, HOST["float32"]), split=0)
    if t == "bfloat16":
        j = j.astype(htj.bfloat16)
    host = np.asarray(j.numpy())  # ml_dtypes' bfloat16 for bfloat16
    p = htt.convert.array_from_numpy(host, split=0)
    _same(p, j)
    assert p.numpy().dtype == (np.float32 if t == "bfloat16" else host.dtype)


def test_item_and_scalars_of_new_types():
    for a in (np.array([7], np.uint8), np.array([1.5], np.float16), np.array([1 + 2j], np.complex64)):
        t, j = htt.array(a), htj.array(a)
        assert t.item() == j.item() and type(t.item()) is type(j.item())
    assert complex(htt.array(np.array([1 + 2j], np.complex64))) == 1 + 2j
    b = htt.array(np.array([1.5], np.float32)).astype(htt.bfloat16)
    assert b.item() == 1.5 and float(b) == 1.5


# ------------------------------------------------------ elementwise and reductions
def _data(t, positive=False):
    rng = np.random.default_rng(sum(map(ord, t)))
    if t == "bool":
        return rng.random((4, 5)) > 0.5
    if t == "uint8":
        return rng.integers(1, 9, size=(4, 5)).astype(np.uint8)
    if t in ("int8", "int16"):
        sign = 1 if positive else rng.choice([-1, 1], size=(4, 5))
        return (rng.integers(1, 9, size=(4, 5)) * sign).astype(t)
    if t.startswith("complex"):
        return (rng.uniform(0.2, 0.9, (4, 5)) + 1j * rng.uniform(-0.9, 0.9, (4, 5))).astype(t)
    return rng.uniform(0.2, 0.9, (4, 5)).astype(np.float32)


def _mk(t, split=0, positive=False):
    return _both(_data(t, positive), split, t if t in ("float16", "bfloat16") else None)


NEW = ["uint8", "int8", "int16", "float16", "bfloat16", "complex64", "complex128"]
UNARY = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square", "cbrt", "sin", "cos",
         "tan", "tanh", "sinh", "cosh", "arcsin", "arctan", "arcsinh", "deg2rad", "rad2deg", "abs", "ceil", "floor",
         "trunc", "fabs", "round", "sign", "sgn", "isfinite", "isnan", "isinf", "signbit", "logical_not", "neg",
         "pos", "angle", "conj", "real", "imag", "iscomplex", "isreal"]


def _both_ways(fn_t, fn_j, rtol=None):
    """Either both packages raise the same exception type, or the results agree."""
    try:
        j = fn_j()
    except Exception as e:
        with pytest.raises(type(e)):
            fn_t()
        return
    t = fn_t()
    if isinstance(j, htj.DNDarray):
        _same(t, j, rtol)
    else:
        assert np.allclose(t, j), (t, j)


@pytest.mark.parametrize("name", UNARY)
@pytest.mark.parametrize("t", NEW)
def test_unary(name, t):
    a, b = _mk(t)
    _both_ways(lambda: getattr(htt, name)(a), lambda: getattr(htj, name)(b))


# one name of each rule family: arithmetic, division, power, extrema, float-only, comparison, logical, bitwise
BINARY = ["add", "sub", "mul", "div", "floordiv", "mod", "pow", "maximum", "hypot", "logaddexp", "eq", "lt", "ge",
          "logical_and", "bitwise_and"]
OTHERS = NEW + ["bool", "int32", "int64", "float32", "float64", "s_int", "s_float", "s_complex"]


@pytest.mark.parametrize("other", OTHERS)
@pytest.mark.parametrize("t", NEW)
def test_binary(t, other):
    a, b = _mk(t)
    if other.startswith("s_"):
        c = d = {"s_int": 3, "s_float": 1.5, "s_complex": 1 + 2j}[other]
    elif other == "bool":
        c, d = _both(np.ones((4, 5), bool))  # no zero divisors: x // 0 is a matter of taste
    elif other in NEW:
        c, d = _mk(other, positive=True)  # integer powers with a negative exponent are undefined in heat_tpu
    else:
        host = np.random.default_rng(5).uniform(0.2, 0.9, (4, 5)) if "float" in other else \
            np.random.default_rng(5).integers(1, 4, (4, 5))
        c, d = _both(host.astype(other))
    for name in BINARY:
        _both_ways(lambda: getattr(htt, name)(a, c), lambda: getattr(htj, name)(b, d))


REDUCTIONS = ["sum", "prod", "mean", "var", "std", "min", "max", "argmin", "argmax", "all", "any", "median"]


@pytest.mark.parametrize("split,axis", [(None, None), (None, 1), (0, None), (0, 0), (1, 0), (1, 1)])
@pytest.mark.parametrize("t", NEW)
def test_reductions(t, split, axis):
    a, b = _mk(t, split)
    for name in REDUCTIONS:
        rtol = 20 * HALF_RTOL[t] if name == "prod" and t in HALF_RTOL else None
        _both_ways(lambda: getattr(htt, name)(a, axis=axis), lambda: getattr(htj, name)(b, axis=axis), rtol)
    for name in ("cumsum", "cumprod"):
        if axis is not None:
            _both_ways(lambda: getattr(htt, name)(a, axis), lambda: getattr(htj, name)(b, axis))


@pytest.mark.parametrize("t", ["float16", "bfloat16", "complex64"])
def test_moments_of_half_and_complex_skip_the_kernel(t):
    """heat_tpu sends only float32 to moments_onepass: half and complex data
    take the plain route and keep their type (the mean of complex is
    complex, its variance real)."""
    a, b = _mk(t)
    htt.kernels.reset_kernel_stats()
    for name in ("mean", "var", "std"):
        _same(getattr(htt, name)(a, axis=0), getattr(htj, name)(b, axis=0))
    assert not any(k.startswith("moments_onepass") for k in htt.KERNEL_STATS), htt.KERNEL_STATS
    f, g = _both(_data("float32"))
    htt.mean(f, axis=0)
    assert htt.KERNEL_STATS.get("moments_onepass.torch") == 1  # float32 takes the kernel's route (plain on the CPU)


def test_random_draws_of_half_types_wait_for_the_16_bit_stream():
    """The 16-bit stream is ported: heat_tpu's float16 rand and bfloat16
    randn bit for bit (tests/test_torch_random16.py holds the rest)."""
    for name, t in (("rand", "float16"), ("randn", "bfloat16")):
        htt.random.seed(5)
        htj.random.seed(5)
        a = getattr(htt.random, name)(4, dtype=getattr(htt, t))
        b = getattr(htj.random, name)(4, dtype=getattr(htj, t))
        assert a.dtype.__name__ == t
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()).astype(np.float32))


@pytest.mark.parametrize("t", ["uint8", "int8", "int16"])
def test_randint_of_small_integer_types_is_heat_tpus_stream(t):
    """heat_tpu draws randint in int64 and casts: the port's stream, cast."""
    htt.random.seed(17)
    htj.random.seed(17)
    _same(htt.random.randint(0, 100, size=(5, 3), dtype=getattr(htt, t), split=0),
          htj.random.randint(0, 100, size=(5, 3), dtype=getattr(htj, t), split=0))


def test_weighted_histogram_keeps_numpys_counts():
    """C4: heat_tpu's histogram takes ``weights`` and never passes it on
    (heat_tpu/core/statistics.py:235-241); the port keeps numpy's weighted
    counts."""
    x, w = np.arange(5.0), np.full(5, 3.0)
    counts, edges = htt.histogram(htt.array(x), bins=2, weights=htt.full((5,), 3.0))
    want, want_edges = np.histogram(x, bins=2, weights=w)
    np.testing.assert_array_equal(counts.numpy(), [6, 9])
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_allclose(edges.numpy(), want_edges)
    assert builtins.list(htj.histogram(htj.array(x), bins=2, weights=htj.full((5,), 3.0))[0].numpy()) == [2, 3]
