"""heat_tpu_torch's printing against heat_tpu, on the CPU: the options
(``get_printoptions``/``set_printoptions`` with their profiles and
``sci_mode``), ``str``/``repr`` of arrays of each type and split, the
summary of a large array from its edges, ``local_printing``/
``global_printing`` and ``print0``. heat_tpu runs under
``comm_context(SELF)``, at world size 1 as the port does. The texts are
compared whole, except for bfloat16, whose values numpy prints as the
float32 the port's ``numpy()`` gives (heat_tpu prints ``ml_dtypes``'
shortest form): there only the dtype, device and split are compared.
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core import printing as printing_j
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        for m in (htt, htj):
            m.set_printoptions(profile="default")
            m.global_printing()
        htt.use_device(None)


_rng = np.random.default_rng(3)
DATA = {
    "float32": (_rng.normal(size=(4, 5)) * 100).astype(np.float32),
    "float64": _rng.normal(size=(3, 2)),
    "int16": _rng.integers(-500, 500, size=(4, 3)).astype(np.int16),
    "uint8": _rng.integers(0, 255, size=(2, 6)).astype(np.uint8),
    "bool": _rng.random((3, 3)) > 0.5,
    "complex64": (_rng.normal(size=(3, 2)) + 1j * _rng.normal(size=(3, 2))).astype(np.complex64),
    "float16": _rng.normal(size=(5,)).astype(np.float16),
    "scalar": np.float32(2.5),
}


def test_default_options():
    assert htt.get_printoptions() == htj.get_printoptions()
    assert htt.get_printoptions() == dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(DATA))
def test_str_and_repr(name, split):
    a = DATA[name]
    if split is not None and split >= np.ndim(a):
        split = None
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    assert str(t) == str(j) and repr(t) == repr(j)


@pytest.mark.parametrize("opts", [dict(precision=2), dict(precision=6, linewidth=40), dict(sci_mode=True),
                                  dict(sci_mode=False), dict(profile="short"), dict(profile="full"),
                                  dict(threshold=5, edgeitems=1), dict(edgeitems=2, threshold=10)])
def test_set_printoptions(opts):
    htt.set_printoptions(**opts)
    htj.set_printoptions(**opts)
    assert htt.get_printoptions() == htj.get_printoptions()
    for name in ("float32", "complex64", "int16"):
        for split in (None, 0):
            t, j = htt.array(DATA[name], split=split), htj.array(DATA[name], split=split)
            assert str(t) == str(j)


@pytest.mark.parametrize("shape", [(3000,), (50, 60), (4, 300), (2, 3, 400)])
@pytest.mark.parametrize("split", [None, 0, -1])
def test_large_arrays_print_from_their_edges(shape, split):
    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) / 7
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    assert str(t) == str(j)
    assert "..." in str(t)


def test_bfloat16_prints_its_float32_values():
    a = np.array([1.5, 2.25, -3.0], np.float32)
    t, j = htt.array(a).astype(htt.bfloat16), htj.array(a).astype(htj.bfloat16)
    assert str(t).endswith(str(j)[str(j).index(", dtype="):])
    assert str(t).startswith("DNDarray([ 1.5 ,  2.25, -3.  ]")


def test_local_printing_shows_this_ranks_chunk():
    a = DATA["float32"]
    t = htt.array(a, split=0)
    htt.local_printing()
    assert printing_j.LOCAL_PRINT is False
    htj.local_printing()
    assert str(t) == str(htj.array(a, split=0))  # one rank: its chunk is the array
    htt.global_printing()
    htj.global_printing()
    assert str(t) == str(htj.array(a, split=0))


def test_print0(capsys):
    htt.print0("hello", 3, sep="-")
    htj.print0("hello", 3, sep="-")
    out = capsys.readouterr().out
    assert out == "hello-3\nhello-3\n"
