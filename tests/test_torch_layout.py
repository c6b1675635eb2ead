"""heat_tpu_torch's layouts and parallel primitives at world size 1, against
heat_tpu, on the CPU: the flatmove schedules, the tile views, the meshes,
``redistribute_``'s validation, the attentions, and the kernels' plain
versions on no rows.

heat_tpu runs under ``comm_context(SELF)`` (world size 1, as the port does
here), except for the pure-numpy schedules and the meshes, whose shapes do
not depend on a communicator. Every map is the ceil-div one at world size
1, so ragged layouts, moves and their counters are held against heat_tpu
on four ranks in ``tests/test_torch_dist.py`` (cases ``redistribute``,
``ragged_ops``, ``ragged_kmeans``, ``flatmove`` and ``parallel``).

Tolerances: schedules, tiles, metadata and messages exact. Attention in
float32: every output row is a convex combination of rows of v, formed by
an online softmax over N keys whose partial sums both packages round in
another order (heat_tpu folds one block, the port key slices), so the two
differ by a few float32 roundings of sums of at most N terms of size
<= max|v|: N u max|v| = 64 * 2^-24 * 4 = 1.5e-5 for the inputs below;
atol 2e-5.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context
from heat_tpu.parallel import flatmove as jflat

import heat_tpu_torch as htt
from heat_tpu_torch.core.kernels import assign_stats, chunk_moments, lloyd_local, merge_moments, moments_local
from heat_tpu_torch.parallel import flatmove as tflat

ATTN_ATOL = 2e-5


@pytest.fixture
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _partition(draw, p, n):
    cuts = sorted(draw(st.lists(st.integers(0, n), min_size=p - 1, max_size=p - 1)))
    return list(np.diff([0] + cuts + [n]).astype(int))


@st.composite
def two_partitions(draw, p):
    n = draw(st.integers(0, 60))
    return _partition(draw, p, n), _partition(draw, p, n)


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_flat_schedule_matches_heat_tpu(p, data):
    a, b = data.draw(two_partitions(p))
    got, want = tflat.flat_schedule(a, b), jflat.flat_schedule(a, b)
    assert [tuple(e) for e in got[0]] == [tuple(e) for e in want[0]]
    assert [[tuple(e) for e in r] for r in got[1]] == [[tuple(e) for e in r] for r in want[1]]
    for rnd in got[1]:  # a matching: every rank at most once a source and once a destination
        assert len({e.src for e in rnd}) == len(rnd) == len({e.dst for e in rnd})


@pytest.mark.parametrize("p", [1, 2, 4, 7])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_bucket_schedule_matches_heat_tpu(p, data):
    m = data.draw(st.lists(st.lists(st.integers(0, 9), min_size=p, max_size=p), min_size=p, max_size=p))
    got, want = tflat.bucket_schedule(m), jflat.bucket_schedule(m)
    assert [tuple(e) for e in got[0]] == [tuple(e) for e in want[0]]
    assert [[tuple(e) for e in r] for r in got[1]] == [[tuple(e) for e in r] for r in want[1]]


@pytest.mark.parametrize("bad", [[[1, 2, 3]], [[1, -1], [0, 0]]])
def test_bucket_schedule_rejects_what_heat_tpu_rejects(bad):
    with pytest.raises(ValueError) as t:
        tflat.bucket_schedule(bad)
    with pytest.raises(ValueError) as j:
        jflat.bucket_schedule(bad)
    assert str(t.value) == str(j.value)


def test_flat_schedule_rejects_unequal_totals():
    with pytest.raises(ValueError, match="count sums differ"):
        tflat.flat_schedule([1, 2], [2, 2])


def test_moves_at_world_size_1_are_local_slices(cpu_self):
    """One rank: every edge is a self-edge, the moves return their input's
    rows, and each dispatch is counted as heat_tpu counts it."""
    x = torch.arange(24.0).reshape(6, 4)
    before = dict(htt.MOVE_STATS)
    assert torch.equal(tflat.ragged_move(x, 0, [6], [6], htt.get_comm()), x)
    assert torch.equal(tflat.bucket_move(x, 0, [[6]], htt.get_comm()), x)
    got, m = tflat.strided_take(x, 0, 6, 1, 6, 2, htt.get_comm())
    assert m == 3 and torch.equal(got, x[1:6:2])
    assert torch.equal(tflat.reshape_via_flatmove(x, (6, 4), (8, 3), htt.get_comm()), x.reshape(8, 3))
    assert {k: htt.MOVE_STATS[k] - before[k] for k in before} == {
        "ragged_moves": 2, "bucket_moves": 1, "tree_merges": 0, "tree_merge_rounds": 0}
    with pytest.raises(ValueError, match="step > 0"):
        tflat.strided_take(x, 0, 6, 5, 0, -1, htt.get_comm())


_T = np.arange(7 * 5, dtype=np.float32).reshape(7, 5)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("key", [0, (0, 0), slice(0, 1), (slice(None), 0)])
def test_split_tiles_match_heat_tpu(cpu_self, split, key):
    t, j = htt.SplitTiles(htt.array(_T, split=split)), htj.SplitTiles(htj.array(_T, split=split))
    np.testing.assert_array_equal(t.tile_ends_g, j.tile_ends_g)
    np.testing.assert_array_equal(t.tile_locations, j.tile_locations)
    np.testing.assert_array_equal(t.tile_dimensions, j.tile_dimensions)
    np.testing.assert_array_equal(t[key], j[key])
    t[key] = -1.0
    j[key] = -1.0
    np.testing.assert_array_equal(t.arr.numpy(), np.asarray(j.arr.numpy()))


@pytest.mark.parametrize("tiles_per_proc", [1, 2, 3])
@pytest.mark.parametrize("key", [(0, 0), (1, slice(0, 2)), 0, (slice(None), 1)])
def test_square_diag_tile_views_match_heat_tpu(cpu_self, tiles_per_proc, key):
    a = np.arange(9 * 6, dtype=np.float32).reshape(9, 6)
    t = htt.tiling.SquareDiagTiles(htt.array(a, split=0), tiles_per_proc)
    j = htj.tiling.SquareDiagTiles(htj.array(a, split=0), tiles_per_proc)
    try:
        want = j[key]
    except IndexError as e:  # a tile past the last: the same error from both
        with pytest.raises(IndexError, match=str(e)):
            t[key]
        return
    np.testing.assert_array_equal(t[key], want)
    t[key] = 5.0
    j[key] = 5.0
    np.testing.assert_array_equal(t.arr.numpy(), np.asarray(j.arr.numpy()))


def test_tile_index_errors_match_heat_tpu(cpu_self):
    t, j = htt.SplitTiles(htt.array(_T, split=0)), htj.SplitTiles(htj.array(_T, split=0))
    for key in (5, slice(0, 1, 2)):
        with pytest.raises(IndexError) as et:
            t[key]
        with pytest.raises(IndexError) as ej:
            j[key]
        assert str(et.value) == str(ej.value)


def _mesh_shape(m):
    return tuple(m.devices.shape) if hasattr(m, "devices") else tuple(m.shape)


def _mesh_names(m):
    return tuple(m.axis_names) if hasattr(m, "axis_names") else tuple(m.mesh_dim_names)


@pytest.mark.parametrize("n_slow,count", [(1, 4), (2, 4), (4, 4), (3, 6)])
def test_hierarchical_mesh_shape_and_names_match_heat_tpu(n_slow, count):
    import jax

    j = htj.parallel.make_hierarchical_mesh(n_slow, devices=jax.devices()[:count], slow_axis="slow")
    t = htt.parallel.make_hierarchical_mesh(n_slow, devices=range(count), slow_axis="slow")
    assert _mesh_shape(t) == _mesh_shape(j) and _mesh_names(t) == _mesh_names(j) == ("slow", "split")
    assert t.mesh.tolist() == np.arange(count).reshape(n_slow, -1).tolist()


def test_flat_mesh_and_defaults():
    t = htt.parallel.make_mesh(axis_name="data")
    assert _mesh_shape(t) == (1,) and _mesh_names(t) == ("data",) and t.size() == 1
    h = htt.parallel.make_hierarchical_mesh()  # one host, every rank: (1, world size)
    assert _mesh_shape(h) == (1, 1) and _mesh_names(h) == ("nodes", "split")


@pytest.mark.parametrize("n_slow,picks", [(0, [0, 1, 2, 3]), (3, [0, 1, 2, 3]), (2, [0, 0, 1, 2])])
def test_mesh_errors_match_heat_tpu(n_slow, picks):
    import jax

    with pytest.raises(ValueError) as j:
        htj.parallel.make_hierarchical_mesh(n_slow, devices=[jax.devices()[i] for i in picks], validate=True)
    with pytest.raises(ValueError) as t:
        htt.parallel.make_hierarchical_mesh(n_slow, devices=picks, validate=True)
    assert str(t.value) == str(j.value)


def test_mesh_coverage_error():
    """Without a device list the mesh must cover every rank: heat_tpu's
    message for a mesh that misses one."""
    from heat_tpu_torch.parallel.mesh import _validate_mesh_devices

    with pytest.raises(ValueError, match=r"does not cover addressable device id\(s\) \[0\]"):
        _validate_mesh_devices(np.array([[5]]), check_coverage=True)


_BAD_MAPS = {
    "shape": lambda n: np.zeros((2, 2), int),
    "negative": lambda n: np.array([[-1, 3]]),
    "sum": lambda n: np.array([[n + 1, 3]]),
    "other": lambda n: np.array([[n, 4]]),
}


@pytest.mark.parametrize("bad", sorted(_BAD_MAPS))
def test_redistribute_rejects_what_heat_tpu_rejects_with_its_message(cpu_self, bad):
    a = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    t, j = htt.array(a, split=0), htj.array(a, split=0)
    with pytest.raises(ValueError) as et:
        t.redistribute_(target_map=_BAD_MAPS[bad](5))
    with pytest.raises(ValueError) as ej:
        j.redistribute_(target_map=_BAD_MAPS[bad](5))
    assert str(et.value) == str(ej.value)


def test_redistribute_checks_the_lshape_map_hint(cpu_self):
    a = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    t, j = htt.array(a, split=0), htj.array(a, split=0)
    with pytest.raises(ValueError) as et:
        t.redistribute_(lshape_map=np.array([[4, 3]]))
    with pytest.raises(ValueError) as ej:
        j.redistribute_(lshape_map=np.array([[4, 3]]))
    assert str(et.value) == str(ej.value)
    # the current map is no move (at world size 1 every axis's ceil-div map is the current one)
    t.redistribute_(lshape_map=t.lshape_map, target_map=t.lshape_map)
    assert t.balanced and t.is_balanced() and t.lcounts is None
    for x in (t, j):
        x.redistribute_(target_map=x.comm.lshape_map(x.gshape, 1))
    assert t.split == j.split == 0
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


_RNG = np.random.default_rng(17)
_QKV2 = [_RNG.normal(size=(37, 16)).astype(np.float32) for _ in range(3)]
_QKV3 = [_RNG.normal(size=(29, 3, 8)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [None, 30])
def test_dense_attention_matches_heat_tpu(causal, kv_len):
    import jax.numpy as jnp

    q, k, v = _QKV2
    want = np.asarray(htj.parallel.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, kv_len=kv_len))
    got = htt.parallel.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_heat_tpu_at_world_size_1(cpu_self, causal):
    import jax.numpy as jnp

    want = np.asarray(htj.parallel.ring_attention(*(jnp.asarray(a) for a in _QKV2), SELF, causal=causal))
    for split in (0, None):
        got = htt.parallel.ring_attention(*(htt.array(a, split=split) for a in _QKV2), causal=causal)
        assert got.split == split and got.gshape == (37, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_ATOL)
    # heads as a leading axis: each head's sequence is attended on its own
    heads = htt.parallel.ring_attention(*(htt.array(np.moveaxis(a, 1, 0), split=1) for a in _QKV3), causal=causal)
    for h in range(3):
        one = np.asarray(htj.parallel.ring_attention(*(jnp.asarray(a[:, h]) for a in _QKV3), SELF, causal=causal))
        np.testing.assert_allclose(heads.numpy()[h], one, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_heat_tpu_at_world_size_1(cpu_self, causal):
    import jax.numpy as jnp

    want = np.asarray(htj.parallel.ulysses_attention(*(jnp.asarray(a) for a in _QKV3), SELF, causal=causal))
    got = htt.parallel.ulysses_attention(*(htt.array(a, split=0) for a in _QKV3), causal=causal)
    assert got.split == 0 and got.gshape == (29, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_ATOL)


def test_attention_errors_match_heat_tpu(cpu_self):
    import jax.numpy as jnp

    q = _QKV3[0]
    with pytest.raises(ValueError) as j:
        htj.parallel.ulysses_attention(jnp.asarray(q[0]), jnp.asarray(q[0]), jnp.asarray(q[0]), SELF)
    with pytest.raises(ValueError) as t:
        htt.parallel.ulysses_attention(*(htt.array(q[0], split=0),) * 3)
    assert type(t.value) is type(j.value)
    with pytest.raises(ValueError, match="shapes differ"):
        htt.parallel.ulysses_attention(htt.array(q, split=0), htt.array(q[:5], split=0), htt.array(q, split=0))


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_matches_heat_tpu_at_world_size_1(cpu_self, halo):
    a = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    want = np.asarray(htj.parallel.halo_exchange(htj.array(a, split=0).larray, halo, SELF))
    got = htt.parallel.halo_exchange(htt.array(a, split=0), halo)
    assert got.split == 0 and got.gshape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_map_and_reduce_match_heat_tpu_at_world_size_1(cpu_self):
    import jax.numpy as jnp

    x, y = _QKV2[0][:8], _QKV2[1][:12]

    def d2(a, b):
        return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)

    want = np.asarray(htj.parallel.ring_map(d2, jnp.asarray(x), jnp.asarray(y), SELF))
    got = htt.parallel.ring_map(d2, htt.array(x, split=0), htt.array(y, split=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    red = htt.parallel.ring_reduce(lambda a, b: d2(a, b).amin(1), torch.minimum,
                                   lambda a: torch.full((a.shape[0],), float("inf")),
                                   htt.array(x, split=0), htt.array(y, split=0))
    np.testing.assert_allclose(red.numpy(), want.min(1), rtol=1e-6)


def test_plain_kernels_on_no_rows_give_the_neutral_state():
    """A ragged layout's empty rank: the moments are the merge's neutral
    state (merging it leaves any state as it is), the Lloyd statistics are
    zero with no labels, and the wrappers (the plain version here, a card's
    kernel there) return them without a launch."""
    from heat_tpu_torch.core.kernels import LAUNCHES

    x0 = torch.zeros((0, 4))
    c = torch.tensor(_QKV2[0][:3, :4])
    before = dict(LAUNCHES)
    for cnt, mean, m2 in (chunk_moments(x0), chunk_moments(x0, 0), moments_local(x0)):
        assert float(cnt) == 0 and not mean.abs().any() and not m2.abs().any()
        other = chunk_moments(c)
        merged = merge_moments(cnt, mean, m2, *other)
        for a, b in zip(merged[1:], other[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for sums, counts, labels, inertia in (assign_stats(x0, c), lloyd_local(x0, c)):
        assert not sums.abs().any() and not counts.abs().any() and labels.shape == (0,) and float(inertia) == 0
    assert dict(LAUNCHES) == before
