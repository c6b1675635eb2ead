"""heat_tpu_torch's DNDarray members, ``pad``'s statistic and ramp modes,
and the small core names (communication, devices, base, version),
against heat_tpu, on the CPU.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does; the members are compared on arrays of several types and splits.
Across ranks the halos, the split-axis ``pad`` and the layout members are
held against heat_tpu on a mesh of the same size in
``tests/test_torch_dist.py``.

Tolerances: layout members, sizes, strides, halos and the parts of a
number exact; ``pad``'s ``mean``/``median``/``linear_ramp`` of float data
rtol 1e-6 (a float32 sum or a ramp computed in another order or width:
a few ulp), of float16 data 4 * 2^-11, and exact for integers (both round
half to even, or floor, the float64 statistic).
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL = 1e-6


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


def _same(t, j, rtol=RTOL):
    assert isinstance(t, htt.DNDarray) and isinstance(j, htj.DNDarray), (type(t), type(j))
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    tn, jn = t.numpy(), _host(j)
    if tn.dtype.kind in "biu":
        np.testing.assert_array_equal(tn, jn)
    else:
        np.testing.assert_allclose(tn, jn, rtol=rtol, atol=rtol * (np.abs(jn).max() if jn.size else 0.0))


_rng = np.random.default_rng(5)
ARRAYS = {
    "f32": _rng.normal(size=(7, 5)).astype(np.float32),
    "u8": _rng.integers(0, 255, size=(7, 5)).astype(np.uint8),
    "c64": (_rng.normal(size=(7, 5)) + 1j * _rng.normal(size=(7, 5))).astype(np.complex64),
    "i16_3d": _rng.integers(-9, 9, size=(3, 4, 2)).astype(np.int16),
    "f16_1d": _rng.normal(size=9).astype(np.float16),
}
CASES = [(name, split) for name, a in ARRAYS.items() for split in [None] + list(range(a.ndim))]


@pytest.mark.parametrize("name,split", CASES)
def test_layout_and_size_members(name, split):
    a = ARRAYS[name]
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    for m in ("pshape", "lcounts", "padded", "balanced", "gnumel", "lnumel", "nbytes", "gnbytes", "lnbytes",
              "stride", "strides", "shape", "gshape", "lshape", "size", "ndim", "split"):
        assert getattr(t, m) == getattr(j, m), m
    np.testing.assert_array_equal(t.create_lshape_map(), j.create_lshape_map())
    np.testing.assert_array_equal(t.create_lshape_map(force_check=True), j.lshape_map)
    assert t.is_distributed() == j.is_distributed() is False
    assert t.is_balanced() == j.is_balanced()
    if split is None:
        for x in (t, j):
            with pytest.raises(ValueError):
                x.counts_displs()
    else:
        assert t.counts_displs() == j.counts_displs()
    shards_t, shards_j = t.local_shards, j.local_shards
    assert len(shards_t) == len(shards_j) == 1
    np.testing.assert_array_equal(shards_t[0].numpy(), np.asarray(shards_j[0]))
    assert t.strides == a.strides  # numpy's byte strides of the C-contiguous array


@pytest.mark.parametrize("name,split", CASES)
def test_real_imag_loc_lloc_cpu(name, split):
    a = ARRAYS[name]
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    _same(t.real, j.real)
    _same(t.imag, j.imag)
    key = (0,) + (slice(1, 3),) * (a.ndim - 1)
    for m in ("loc", "lloc"):
        np.testing.assert_array_equal(getattr(t, m)[key].numpy(), np.asarray(getattr(j, m)[key]))
    c_t, c_j = t.cpu(), j.cpu()
    assert c_t.device == htt.cpu and c_t.split is None and c_j.split is None
    _same(c_t, c_j)


@pytest.mark.parametrize("shape", [(5, 5), (4, 7), (7, 3)])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("value", [3, 2.5, 1 - 1j])
def test_fill_diagonal(shape, split, value):
    a = np.arange(np.prod(shape)).reshape(shape).astype(np.complex64 if isinstance(value, complex) else np.float32)
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    before = t.larray
    assert t.fill_diagonal(value) is t
    j.fill_diagonal(value)
    _same(t, j)
    assert not np.array_equal(before.numpy(), t.larray.numpy())  # a new tensor: earlier views keep their values
    with pytest.raises(ValueError):
        htt.array(np.zeros(3)).fill_diagonal(1)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_halos_at_world_size_one(split):
    """One rank has no neighbour: no halo, as heat_tpu gives none on one
    device; array_with_halos is the chunk itself."""
    t, j = htt.array(ARRAYS["f32"], split=split), htj.array(ARRAYS["f32"], split=split)
    assert t.halo_size == j.halo_size == 0
    for hs in (0, 1, 3):
        t.get_halo(hs)
        j.get_halo(hs)
        assert t.halo_size == j.halo_size == hs
        assert t.halo_prev is None and j.halo_prev is None
        assert t.halo_next is None and j.halo_next is None
        np.testing.assert_array_equal(t.array_with_halos().numpy(), ARRAYS["f32"])
    for bad, err in ((-1, ValueError), (1.5, TypeError), ("2", TypeError)):
        for x in (t, j):
            with pytest.raises(err):
                x.get_halo(bad)


# ------------------------------------------------------------------ pad
PAD_MODES = ["linear_ramp", "maximum", "mean", "median", "minimum", "empty"]
PAD_DATA = {
    "float32": (_rng.normal(size=(5, 4)) * 10).astype(np.float32),
    "float64": (_rng.normal(size=(5, 4)) * 10).astype(np.float64),
    "int32": _rng.integers(-50, 50, size=(5, 4)).astype(np.int32),
    "uint8": _rng.integers(0, 255, size=(5, 4)).astype(np.uint8),
    "float16": (_rng.normal(size=(5, 4)) * 10).astype(np.float16),
    "complex64": (_rng.normal(size=(5, 4)) + 1j * _rng.normal(size=(5, 4))).astype(np.complex64),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("width", [2, ((1, 3), (2, 0)), ((0, 0), (3, 1)), (2, 1)])
@pytest.mark.parametrize("dtype", sorted(PAD_DATA))
@pytest.mark.parametrize("mode", PAD_MODES)
def test_pad_modes(mode, dtype, width, split):
    a = PAD_DATA[dtype]
    t, j = htt.array(a, split=split), htj.array(a, split=split)
    try:
        want = htj.pad(j, width, mode)
    except Exception as e:
        with pytest.raises(type(e)):
            htt.pad(t, width, mode)
        return
    _same(htt.pad(t, width, mode), want, rtol=4 * 2.0 ** -11 if dtype == "float16" else RTOL)


def test_pad_linear_ramp_of_the_probe():
    t, j = htt.arange(5.0), htj.arange(5.0)
    np.testing.assert_array_equal(htt.pad(t, 2, "linear_ramp").numpy(), [0, 0, 0, 1, 2, 3, 4, 2, 0])
    _same(htt.pad(t, 2, "linear_ramp"), htj.pad(j, 2, "linear_ramp"))


def test_pad_of_an_empty_axis_raises():
    for m in (htt, htj):
        with pytest.raises(ValueError):
            m.pad(m.zeros((0, 3)), 1, "maximum")


# ---------------------------------------------------------- small core names
def test_communication_names():
    from heat_tpu_torch.core import communication as comm

    assert htt.MPI_WORLD is htt.WORLD and htt.MPI_SELF is htt.SELF
    assert htt.MPICommunication is htt.MeshCommunication is htt.TorchCommunication
    assert htt.SPLIT_AXIS == htj.SPLIT_AXIS and htt.CUDA_AWARE_MPI is htj.CUDA_AWARE_MPI is False
    assert htt.SELF.size == 1 and htt.SELF.rank == 0 and not htt.SELF.is_distributed()
    assert htt.SELF != htt.WORLD and htt.SELF == comm._SelfCommunication()
    with comm.comm_context(htt.SELF):
        x = htt.array(ARRAYS["f32"], split=0)
        assert x.comm is htt.SELF and htt.get_comm() is htt.SELF
    assert htt.get_comm() is htt.WORLD
    assert htt.devices.ACCEL_NAMES == ("gpu", "cuda")


def test_base_mixins_and_predicates():
    class Reg(htt.BaseEstimator, htt.RegressionMixin):
        pass

    class Tr(htt.BaseEstimator, htt.TransformMixin):
        pass

    class RegJ(htj.BaseEstimator, htj.RegressionMixin):
        pass

    class TrJ(htj.BaseEstimator, htj.TransformMixin):
        pass

    for mod, reg, tr in ((htt, Reg(), Tr()), (htj, RegJ(), TrJ())):
        assert mod.is_regressor(reg) and not mod.is_regressor(tr)
        assert mod.is_transformer(tr) and not mod.is_transformer(reg)
        with pytest.raises(NotImplementedError):
            tr.fit_transform(None)
        with pytest.raises(NotImplementedError):
            reg.fit_predict(None, None)


def test_version():
    assert htt.__version__ == htt.version.__version__
    assert (htt.version.major, htt.version.minor, htt.version.micro) == (htj.version.major, htj.version.minor,
                                                                          htj.version.micro)
    assert htt.__version__.endswith("-torch")
