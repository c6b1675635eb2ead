"""heat_tpu_torch's float16 and bfloat16 draws against heat_tpu's, on the CPU.

jax draws narrower words for the 16-bit types than for float32 (16-bit
words for float16, 8-bit words for bfloat16), so a seed gives other bits
there than the float32 draw rounded. The port's ``threefry_bits`` has
16-bit kinds for them; its plain version runs here. heat_tpu runs under
``comm_context(SELF)``, at world size 1 as the port does.

Tolerances: ``rand`` bit for bit. ``randn`` bit for bit wherever the
port's float32 ``erf_inv`` agrees with XLA's after rounding to 16 bits;
where the two ``log1p`` round differently the 16-bit result may move by
one unit in the last place, so a differing element is allowed 1 ulp of
the 16-bit type, and at most 1 % of the elements may differ (none did on
these seeds). The generator's counter advances as heat_tpu's does.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

SHAPES = [(7, 5), (1000, 33)]
SPLITS = [None, 0, 1]
TYPES = ["float16", "bfloat16"]
MAX_DIFFERING = 0.01  # share of randn elements allowed to differ (by one ulp)


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _bits(a: np.ndarray, t: str) -> np.ndarray:
    """The 16-bit patterns of float32-held values of type ``t``, as int32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(getattr(torch, t)).view(torch.int16).to(
        torch.int32).numpy()


def _draw(name, t, shape, split, seed, counter=0):
    state = ("Threefry", seed, counter)
    htt.random.set_state(state)
    htj.random.set_state(state)
    a = getattr(htt.random, name)(*shape, dtype=getattr(htt, t), split=split)
    b = getattr(htj.random, name)(*shape, dtype=getattr(htj, t), split=split)
    assert a.dtype.__name__ == b.dtype.__name__ == t
    assert tuple(a.gshape) == tuple(b.gshape) and a.split == b.split
    np.testing.assert_array_equal(a.lshape_map, b.lshape_map)
    assert htt.random.get_state() == htj.random.get_state()
    return a.numpy(), np.asarray(b.numpy()).astype(np.float32)


@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_rand_is_heat_tpus_stream_bit_for_bit(t, shape, split):
    got, want = _draw("rand", t, shape, split, seed=3 + len(shape) * shape[0])
    np.testing.assert_array_equal(_bits(got, t), _bits(want, t))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_randn_within_one_ulp_of_heat_tpu(t, shape, split):
    got, want = _draw("randn", t, shape, split, seed=11 + shape[0])
    assert np.isfinite(got).all()
    d = np.abs(_bits(got, t) - _bits(want, t))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= MAX_DIFFERING, (d > 0).sum()


@pytest.mark.parametrize("t", TYPES)
def test_draws_at_a_counter_and_after_other_draws(t):
    """The counter moves on by the element count, as for 32-bit draws: a
    float32 draw, a 16-bit draw and another 16-bit one in sequence."""
    for pkg in (htt, htj):
        pkg.random.seed(42)
    outs = []
    for pkg in (htt, htj):
        pkg.random.seed(42)
        pkg.random.rand(3, 4)
        x = pkg.random.rand(9, 5, dtype=getattr(pkg, t), split=0)
        y = pkg.random.randn(6, dtype=getattr(pkg, t))
        outs.append((np.asarray(x.numpy()).astype(np.float32), np.asarray(y.numpy()).astype(np.float32),
                     pkg.random.get_state()))
    (x1, y1, s1), (x2, y2, s2) = outs
    assert s1 == s2 == ("Threefry", 42, 12 + 45 + 6, 0, 0.0)
    np.testing.assert_array_equal(_bits(x1, t), _bits(x2, t))
    assert np.abs(_bits(y1, t) - _bits(y2, t)).max() <= 1
    got, want = _draw("rand", t, (5, 8), 1, seed=7, counter=123456)
    np.testing.assert_array_equal(_bits(got, t), _bits(want, t))


@pytest.mark.parametrize("kind", ["uniform16", "normal16", "uniformbf16", "normalbf16"])
def test_threefry_bits_16_bit_kinds_on_the_cpu_are_the_plain_version(kind):
    """The wrapper runs the plain version on the CPU, at a chunk's global
    indices: a split-1 chunk of a (6, 10) draw equals those columns of the
    whole draw."""
    from heat_tpu_torch.core.kernels.threefry import chunk_layout

    key = (12345, 678)
    whole = htt.kernels.threefry_bits(key, chunk_layout((6, 10), None, 0, 0), kind, "cpu", -0.99951171875, 2.0)
    part = htt.kernels.threefry_bits(key, chunk_layout((6, 10), 1, 4, 3), kind, "cpu", -0.99951171875, 2.0)
    assert whole.dtype == (torch.float16 if kind.endswith("16") and "bf" not in kind else torch.bfloat16)
    assert torch.equal(part.reshape(6, 3).view(torch.int16), whole.reshape(6, 10)[:, 4:7].contiguous().view(torch.int16))
