"""heat_tpu_torch's ``__setitem__`` and its advanced ``__getitem__`` (bool
masks, integer arrays, negative steps, coordinate lists) against
heat_tpu's, on the CPU at world size 1.

The same seeded numpy inputs go through both packages, heat_tpu under
``comm_context(SELF)``: values (exact: indexing moves elements, and a
written value is cast once to the array's dtype in both), dtype,
``gshape``, ``split`` and ``lshape_map``. Writes across ranks (slices,
masks and integer arrays over the chunk boundaries, with split and
replicated values) run in the 4-rank gloo session of
``tests/test_torch_dist.py`` (its ``setitem`` case).
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


A = np.random.default_rng(0).normal(size=(9, 5)).astype(np.float32)
C3 = np.random.default_rng(1).normal(size=(4, 3, 5)).astype(np.float32)
I = np.random.default_rng(2).integers(-5, 5, size=(7, 4)).astype(np.int32)


def _same(t, j, what=""):
    assert t.dtype.__name__ == j.dtype.__name__, f"{what}: dtype {t.dtype} vs {j.dtype}"
    assert tuple(t.gshape) == tuple(j.gshape), f"{what}: gshape {t.gshape} vs {j.gshape}"
    assert t.split == j.split, f"{what}: split {t.split} vs {j.split}"
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map, err_msg=what)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()), err_msg=what)


def _set(key, value, data=A, split=0):
    def run(ht):
        x = ht.array(data, split=split)
        k = key(ht) if callable(key) else key
        v = value(ht) if callable(value) else value
        x[k] = v
        return x
    return run


SETS = {
    "int_row": _set(3, 7.0),
    "neg_row": _set(-1, 2.5, split=1),
    "elem": _set((4, 2), -1.0),
    "slice": _set(slice(2, 7), 0.5),
    "slice_rows_value": _set(slice(1, 4), lambda ht: ht.array(A[:3] * 10, split=0)),
    "slice_cols": _set((slice(None), slice(1, 3)), lambda ht: ht.array(A[:, :2] + 1, split=0)),
    "step": _set(slice(1, 9, 3), lambda ht: ht.array(np.arange(5, dtype=np.float32))),
    "neg_step": _set(slice(7, 0, -2), lambda ht: ht.array(A[:4] * 3, split=0)),
    "neg_step_cols": _set((slice(None), slice(None, None, -1)), lambda ht: ht.array(A[:, ::-1] * 2, split=1), split=1),
    "broadcast_row": _set((slice(2, 6), slice(None)), lambda ht: ht.array(A[0])),
    "ellipsis": _set((Ellipsis, 0), 9.0, data=C3, split=2),
    "int_cast": _set(slice(0, 3), 2.7, data=I),
    "mask": _set(lambda ht: ht.array(A > 0.5, split=0), 0.0),
    "mask_unsplit": _set(lambda ht: ht.array(A < -0.5), -3.0),
    "mask_values": _set(lambda ht: ht.array(A > 1.0, split=0), lambda ht: ht.array(np.arange(int((A > 1.0).sum()),
                                                                                          dtype=np.float32),
                                                                                split=0)),
    "mask_numpy": _set(A > 0, 1.0, split=1),
    "int_array": _set(lambda ht: [0, 4, 8], -2.0),
    "int_array_values": _set(lambda ht: np.array([6, 1]), lambda ht: ht.array(A[:2] * 5)),
    "int_array_neg": _set(lambda ht: [-1, 2], 4.0, split=1),
    "dnd_int_array": _set(lambda ht: ht.array(np.array([2, 5], dtype=np.int64)), 8.0),
    "coords": _set((np.array([0, 3, 8]), np.array([1, 1, 4])), 6.0),
}

GETS = {
    "neg_step": lambda ht: ht.array(A, split=0)[::-2],
    "neg_step_cols": lambda ht: ht.array(A, split=1)[1:8, ::-1],
    "neg_step_3d": lambda ht: ht.array(C3, split=1)[::-1, ::-2, 1],
    "mask": lambda ht: ht.array(A, split=0)[ht.array(A > 0.3, split=0)],
    "mask_unsplit": lambda ht: ht.array(A)[ht.array(A > 0.3)],
    "mask_split1": lambda ht: ht.array(A, split=1)[ht.array(A > 0.3, split=1)],
    "mask_rows": lambda ht: ht.array(A, split=0)[ht.array(A[:, 0] > 0, split=0)],
    "int_array": lambda ht: ht.array(A, split=0)[[8, 0, 3, 3]],
    "int_array_cols": lambda ht: ht.array(A, split=0)[:, [4, 0]],
    "int_array_split1": lambda ht: ht.array(A, split=1)[:, [4, 0, 1]],
    "int_array_neg": lambda ht: ht.array(A, split=0)[np.array([-1, -9])],
    "dnd_int_array": lambda ht: ht.array(A, split=0)[ht.array(np.array([1, 7], dtype=np.int64))],
    "coords": lambda ht: ht.array(A, split=0)[ht.nonzero(ht.array(A > 1.0, split=0))],
    "newaxis": lambda ht: ht.array(A, split=0)[None, 2:5],
    "mixed": lambda ht: ht.array(C3, split=2)[[0, 2], :, 1:4],
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_setitem_matches_heat_tpu(name):
    _same(SETS[name](htt), SETS[name](htj), what=name)


@pytest.mark.parametrize("name", sorted(GETS))
def test_getitem_matches_heat_tpu(name):
    _same(GETS[name](htt), GETS[name](htj), what=name)


def test_setitem_leaves_earlier_views_alone():
    """As in heat_tpu, a write replaces the array's tensor: a slice taken
    before keeps its values."""
    x = htt.array(A, split=0)
    before = x[2:4]
    kept = before.numpy().copy()
    x[2:4] = 0.0
    np.testing.assert_array_equal(before.numpy(), kept)


@pytest.mark.parametrize("key", [9, (0, 5), -10])
def test_out_of_bounds_raises_index_error(key):
    x = htt.array(A, split=0)
    with pytest.raises(IndexError):
        x[key]
    with pytest.raises(IndexError):
        x[key] = 1.0
