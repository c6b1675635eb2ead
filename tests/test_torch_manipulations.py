"""heat_tpu_torch's manipulations, sort/top-k/unique and the factories'
rest against heat_tpu's, on the CPU at world size 1.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)``. Every case compares values, dtype, ``gshape``,
``split`` and ``lshape_map``. Tolerance: exact (bit for bit) for every
case — these functions move, select or order elements; ``linspace``
computes in float64 as ``jnp.linspace`` does and is exact too; only
``logspace`` (float32 ``pow``, which XLA and torch round differently in
the last bit) is held to 2 ulp (rtol 2.4e-7). The distributed forms run in
the 4-rank gloo session of ``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _rng(seed):
    return np.random.default_rng(seed)


A = _rng(0).normal(size=(7, 5)).astype(np.float32)
B = _rng(1).normal(size=(4, 5)).astype(np.float32)
C3 = _rng(2).normal(size=(3, 4, 5)).astype(np.float32)
I = _rng(3).integers(-4, 5, size=(6, 4)).astype(np.int32)
V = _rng(4).normal(size=11).astype(np.float32)
TIES = np.round(_rng(5).normal(size=(9, 4)) * 2).astype(np.float32)
NANS = TIES.copy()
NANS[[1, 4, 7], [0, 2, 2]] = np.nan
NANS[3, 1] = -0.0


def _same(t, j, rtol=0.0, what=""):
    if isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(t) == len(j), what
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, rtol, f"{what}[{i}]")
        return
    if not hasattr(j, "gshape"):
        assert t == j, what
        return
    assert t.dtype.__name__ == j.dtype.__name__, f"{what}: dtype {t.dtype} vs {j.dtype}"
    assert tuple(t.gshape) == tuple(j.gshape), f"{what}: gshape {t.gshape} vs {j.gshape}"
    assert t.split == j.split, f"{what}: split {t.split} vs {j.split}"
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map, err_msg=what)
    got, want = t.numpy(), np.asarray(j.numpy())
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


CASES = {
    "reshape": lambda ht: ht.reshape(ht.array(A.reshape(-1)[:35], split=0), (5, 7)),
    "reshape_neg": lambda ht: ht.reshape(ht.array(A, split=1), -1),
    "reshape_new_split": lambda ht: ht.reshape(ht.array(C3, split=0), (12, 5), new_split=1),
    "reshape_method": lambda ht: ht.array(C3).reshape(4, 15),
    "flatten": lambda ht: ht.flatten(ht.array(C3, split=2)),
    "ravel": lambda ht: ht.ravel(ht.array(A, split=0)),
    "concatenate0": lambda ht: ht.concatenate([ht.array(A, split=0), ht.array(B, split=0)], axis=0),
    "concatenate1": lambda ht: ht.concatenate([ht.array(A[:4], split=0), ht.array(B)], axis=1),
    "concatenate_promote": lambda ht: ht.concatenate([ht.array(I[:, :2]), ht.array(A[:6, :3])], axis=1),
    "hstack": lambda ht: ht.hstack([ht.array(V, split=0), ht.array(V[:3], split=0)]),
    "vstack": lambda ht: ht.vstack([ht.array(V[:5], split=0), ht.array(A[:2], split=0)]),
    "row_stack": lambda ht: ht.row_stack([ht.array(A), ht.array(B)]),
    "column_stack": lambda ht: ht.column_stack([ht.array(V[:7], split=0), ht.array(A, split=0)]),
    "stack": lambda ht: ht.stack([ht.array(A, split=1), ht.array(A * 2, split=1)], axis=1),
    "stack_last": lambda ht: ht.stack([ht.array(V), ht.array(V)], axis=-1),
    "expand_dims": lambda ht: ht.expand_dims(ht.array(A, split=1), 0),
    "expand_dims_method": lambda ht: ht.array(A, split=0).expand_dims(-1),
    "squeeze": lambda ht: ht.squeeze(ht.array(C3[:1, :, :1], split=1)),
    "squeeze_axis": lambda ht: ht.array(C3[:, :1], split=2).squeeze(1),
    "squeeze_split": lambda ht: ht.squeeze(ht.array(C3[:1], split=0), 0),
    "flip": lambda ht: ht.flip(ht.array(A, split=0), 0),
    "flip_all": lambda ht: ht.flip(ht.array(C3, split=1)),
    "fliplr": lambda ht: ht.fliplr(ht.array(A, split=1)),
    "flipud": lambda ht: ht.flipud(ht.array(A)),
    "flip_method": lambda ht: ht.array(A, split=0).flip((0, 1)),
    "roll": lambda ht: ht.roll(ht.array(A, split=0), 3, 0),
    "roll_neg": lambda ht: ht.roll(ht.array(A, split=0), -9, 1),
    "roll_none": lambda ht: ht.roll(ht.array(A, split=1), 4),
    "roll_tuple": lambda ht: ht.roll(ht.array(C3, split=2), (1, -2), (0, 2)),
    "rot90": lambda ht: ht.rot90(ht.array(A, split=0)),
    "rot90_k2": lambda ht: ht.rot90(ht.array(A, split=1), 2),
    "rot90_k3": lambda ht: ht.rot90(ht.array(C3, split=0), 3, (0, 2)),
    "moveaxis": lambda ht: ht.moveaxis(ht.array(C3, split=0), 0, -1),
    "swapaxes": lambda ht: ht.swapaxes(ht.array(C3, split=2), 0, 2),
    "pad": lambda ht: ht.pad(ht.array(A, split=0), 2),
    "pad_pairs": lambda ht: ht.pad(ht.array(A, split=0), ((1, 3), (0, 2)), constant_values=7.5),
    "pad_flat": lambda ht: ht.pad(ht.array(A, split=1), (2, 1)),
    "pad_values": lambda ht: ht.pad(ht.array(A), ((1, 1), (2, 1)), constant_values=((1.0, 2.0), (3.0, 4.0))),
    "pad_edge": lambda ht: ht.pad(ht.array(A, split=0), ((2, 3), (1, 0)), mode="edge"),
    "pad_reflect": lambda ht: ht.pad(ht.array(A, split=0), ((3, 2), (1, 1)), mode="reflect"),
    "pad_wrap": lambda ht: ht.pad(ht.array(A, split=0), ((9, 4), (0, 0)), mode="wrap"),
    "pad_symmetric": lambda ht: ht.pad(ht.array(A), ((2, 2), (6, 1)), mode="symmetric"),
    "unfold": lambda ht: ht.unfold(ht.array(A, split=0), 0, 3, 2),
    "unfold1": lambda ht: ht.unfold(ht.array(A, split=0), 1, 2),
    "diag": lambda ht: ht.diag(ht.array(V[:5], split=0), 1),
    "diag2d": lambda ht: ht.diag(ht.array(A, split=0), -1),
    "diagonal": lambda ht: ht.diagonal(ht.array(C3, split=2), 1, 0, 2),
    "repeat": lambda ht: ht.repeat(ht.array(A, split=0), 2),
    "repeat_axis": lambda ht: ht.repeat(ht.array(A, split=0), [1, 0, 2, 1, 3], axis=1),
    "tile": lambda ht: ht.tile(ht.array(A, split=0), (2, 1, 2)),
    "broadcast_to": lambda ht: ht.broadcast_to(ht.array(V[:5], split=0), (3, 5)),
    "broadcast_arrays": lambda ht: ht.broadcast_arrays(ht.array(A[:, :1], split=0), ht.array(V[:5])),
    "split": lambda ht: ht.split(ht.array(A[:6], split=0), 3),
    "split_idx": lambda ht: ht.split(ht.array(A, split=1), [1, 3], axis=1),
    "hsplit": lambda ht: ht.hsplit(ht.array(A, split=0), [2]),
    "vsplit": lambda ht: ht.vsplit(ht.array(A, split=0), [2, 5]),
    "dsplit": lambda ht: ht.dsplit(ht.array(C3, split=0), [1, 4]),
    "balance": lambda ht: ht.balance(ht.array(A, split=0), copy=True),
    "redistribute": lambda ht: ht.redistribute(ht.array(A, split=0)),
    "resplit": lambda ht: ht.resplit(ht.array(A, split=0), 1),
    "shape": lambda ht: ht.shape(ht.array(C3, split=1)),
    "sort": lambda ht: ht.sort(ht.array(TIES, split=0), axis=0),
    "sort_desc": lambda ht: ht.sort(ht.array(TIES, split=0), axis=0, descending=True),
    "sort_nan": lambda ht: ht.sort(ht.array(NANS, split=1), axis=0),
    "sort_nan_desc": lambda ht: ht.sort(ht.array(NANS, split=1), axis=0, descending=True),
    "sort_last": lambda ht: ht.sort(ht.array(I, split=0)),
    "sort_int_desc": lambda ht: ht.sort(ht.array(I, split=0), axis=1, descending=True),
    "sort_1d": lambda ht: ht.sort(ht.array(V, split=0)),
    "topk": lambda ht: ht.topk(ht.array(TIES, split=0), 3, dim=0),
    "topk_small": lambda ht: ht.topk(ht.array(TIES, split=1), 2, dim=1, largest=False),
    "topk_nan": lambda ht: ht.topk(ht.array(NANS), 4, dim=0),
    "topk_nan_small": lambda ht: ht.topk(ht.array(NANS), 4, dim=0, largest=False),
    "topk_int": lambda ht: ht.topk(ht.array(I, split=0), 2),
    "unique": lambda ht: ht.unique(ht.array(TIES, split=0)),
    "unique_nan": lambda ht: ht.unique(ht.array(NANS)),
    "unique_inverse": lambda ht: ht.unique(ht.array(I, split=1), return_inverse=True),
    "unique_axis": lambda ht: ht.unique(ht.array(np.concatenate([I, I[:3]]), split=0), axis=0),
    "unique_method": lambda ht: ht.array(I).unique(),
    "linspace": lambda ht: ht.linspace(-1.5, 7, 23, split=0),
    "linspace_open": lambda ht: ht.linspace(0, 1, 10, endpoint=False),
    "linspace_one": lambda ht: ht.linspace(3, 4, 1),
    "linspace_f64": lambda ht: ht.linspace(0.1, 0.9, 17, dtype=ht.float64),
    "linspace_retstep": lambda ht: ht.linspace(2, 3, 5, retstep=True),
    "meshgrid": lambda ht: ht.meshgrid(ht.array(V[:3], split=0), ht.array(V[3:7])),
    "meshgrid_ij": lambda ht: ht.meshgrid(ht.array(V[:3]), ht.array(V[3:7], split=0), indexing="ij"),
    "asarray": lambda ht: ht.asarray(A[:3], dtype=ht.float64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_heat_tpu(name):
    _same(CASES[name](htt), CASES[name](htj), what=name)


def test_logspace_within_two_ulp():
    _same(htt.logspace(0, 2, 9, split=0), htj.logspace(0, 2, 9, split=0), rtol=2.4e-7)
    _same(htt.logspace(1, 3, 4, base=2.0), htj.logspace(1, 3, 4, base=2.0), rtol=2.4e-7)


def test_asarray_returns_the_array_itself():
    x = htt.array(A)
    assert htt.asarray(x) is x


@pytest.mark.parametrize("name, call", [
    ("reshape_size", lambda ht: ht.reshape(ht.array(A), (3, 3))),
    ("concatenate_shapes", lambda ht: ht.concatenate([ht.array(A), ht.array(V)])),
    ("concatenate_splits", lambda ht: ht.concatenate([ht.array(A, split=0), ht.array(A, split=1)])),
    ("squeeze_not_one", lambda ht: ht.squeeze(ht.array(A), 0)),
    ("split_unequal", lambda ht: ht.split(ht.array(A), 2)),
    ("topk_k", lambda ht: ht.topk(ht.array(V), 12)),
    ("unfold_size", lambda ht: ht.unfold(ht.array(A), 0, 8)),
    ("repeat_float", lambda ht: ht.repeat(ht.array(A), [1.5, 2.0], axis=0)),
    ("rot90_axes", lambda ht: ht.rot90(ht.array(A), 1, (0, 0))),
])
def test_raises_as_heat_tpu(name, call):
    with pytest.raises(Exception) as want:
        call(htj)
    with pytest.raises(Exception) as got:
        call(htt)
    assert type(got.value).__name__ == type(want.value).__name__, (got.value, want.value)


def test_sort_indices_are_int64_global_positions_and_stable():
    v, i = htt.sort(htt.array(TIES[:, 0], split=0))
    order = np.argsort(TIES[:, 0], kind="stable")
    np.testing.assert_array_equal(i.numpy(), order)
    assert i.dtype is htt.int64


def test_manipulation_methods_ride_on_the_functions():
    x = htt.array(C3, split=0)
    assert x.reshape((12, 5)).gshape == (12, 5) and x.flatten().split == 0 and x.ravel().gshape == (60,)
    assert x.redistribute_() is x
    # a map that is no layout of x: heat_tpu's error, type and message
    with pytest.raises(ValueError) as want, comm_context(SELF):
        htj.array(C3, split=0).redistribute_(target_map=np.array([[2, 4, 5]]))
    with pytest.raises(ValueError) as got:
        x.redistribute_(target_map=np.array([[2, 4, 5]]))
    assert str(got.value) == str(want.value)
