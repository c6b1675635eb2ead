"""heat_tpu_torch's ``signal.convolve`` against heat_tpu, on the CPU.

The three modes over float32, float64, float16, int32 and complex64
signals, split and replicated, with odd and even kernels; the operands'
swap when the kernel is the longer, the promotion of mixed types
(integers convolve in float, as in jnp), and the argument errors.
heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does; the split-axis stencil over the halos is held against heat_tpu on
a mesh of four devices in ``tests/test_torch_dist.py``.

Tolerances: float32 and complex64 rtol 1e-5 of the largest |result|
(sums of up to 9 products in another order: a few ulp of the terms),
float64 1e-12, float16 4 * 2^-11 (XLA and torch round the float32
accumulation to float16 at different points).
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "float16": 4 * 2.0 ** -11}


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _same(t, j):
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    tn, jn = t.numpy(), np.asarray(j.numpy())
    if tn.dtype.kind in "biu":
        np.testing.assert_array_equal(tn, jn)
    else:
        rtol = RTOL[t.dtype.__name__]
        np.testing.assert_allclose(tn, jn, rtol=rtol, atol=rtol * (np.abs(jn).max() if jn.size else 0.0))


_rng = np.random.default_rng(9)


def _signal(dtype, n):
    if dtype == "int32":
        return _rng.integers(-9, 9, size=n).astype(np.int32)
    if dtype == "complex64":
        return (_rng.normal(size=n) + 1j * _rng.normal(size=n)).astype(np.complex64)
    return _rng.normal(size=n).astype(dtype)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("m", [1, 4, 5, 9])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int32", "complex64"])
def test_convolve(dtype, split, m, mode):
    a, v = _signal(dtype, 23), _signal(dtype, m)
    ta, ja = htt.array(a, split=split), htj.array(a, split=split)
    tv, jv = htt.array(v), htj.array(v)
    try:
        want = htj.convolve(ja, jv, mode)
    except Exception as e:
        with pytest.raises(type(e)):
            htt.convolve(ta, tv, mode)
        return
    _same(htt.convolve(ta, tv, mode), want)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_swaps_a_longer_kernel(mode):
    a, v = _signal("float32", 5), _signal("float32", 17)
    for sa, sv in ((0, None), (None, 0)):
        _same(htt.convolve(htt.array(a, split=sa), htt.array(v, split=sv), mode),
              htj.convolve(htj.array(a, split=sa), htj.array(v, split=sv), mode))


@pytest.mark.parametrize("pair", [("int32", "float32"), ("uint8", "int16"), ("float16", "bfloat16"),
                                  ("float32", "complex64"), ("int8", "float64")])
def test_convolve_promotes(pair):
    a = np.abs(_signal("int32", 12)).astype(pair[0]) if pair[0] != "float16" else _signal("float16", 12)
    v = np.abs(_signal("int32", 3)).astype(pair[1]) if pair[1] not in ("bfloat16", "complex64", "float64") else None
    ta, ja = htt.array(a, split=0), htj.array(a, split=0)
    if v is None:
        host = _signal("complex64" if pair[1] == "complex64" else "float32", 3)
        tv, jv = htt.array(host), htj.array(host)
        if pair[1] in ("bfloat16", "float64"):
            tv, jv = tv.astype(getattr(htt, pair[1])), jv.astype(getattr(htj, pair[1]))
    else:
        tv, jv = htt.array(v), htj.array(v)
    t, j = htt.convolve(ta, tv), htj.convolve(ja, jv)
    promoted = htt.promote_types(ta.dtype, tv.dtype)
    if htt.heat_type_is_exact(promoted):  # jnp convolves integers in float
        promoted = htt.promote_types(promoted, htt.float32)
    assert t.dtype.__name__ == j.dtype.__name__ == promoted.__name__
    if t.dtype.__name__ != "bfloat16":
        _same(t, j)


def test_convolve_takes_array_likes_and_the_probe():
    t = htt.convolve([1.0, 2.0, 3.0], [0.0, 1.0, 0.5])
    np.testing.assert_allclose(t.numpy(), np.convolve([1.0, 2.0, 3.0], [0.0, 1.0, 0.5]))
    _same(t, htj.convolve([1.0, 2.0, 3.0], [0.0, 1.0, 0.5]))


def test_convolve_argument_errors():
    for m in (htt, htj):
        a = m.array(np.ones(8, np.float32))
        with pytest.raises(ValueError):
            m.convolve(a, m.array(np.ones(4, np.float32)), "same")  # even kernel
        with pytest.raises(ValueError):
            m.convolve(a, m.array(np.ones(3, np.float32)), "circular")
        with pytest.raises(ValueError):
            m.convolve(m.array(np.ones((2, 4), np.float32)), m.array(np.ones(3, np.float32)))


@pytest.mark.parametrize("flag", [True, False])
def test_convolve_restores_cudnns_tf32_switch(flag):
    """convolve turns cuDNN's TF32 mode off for its own call and puts the
    caller's setting back."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = flag
    try:
        htt.convolve(htt.array(np.ones(16, np.float32)), htt.array(np.ones(3, np.float32)))
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before
