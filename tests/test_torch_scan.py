"""heat_tpu_torch's scan (``scan_axis`` and its plain version, behind
cumsum/cumprod) and the lazy layer's terminal sum, on the CPU, against
heat_tpu.

- ``scan_axis_plain`` with tiles of several sizes (the kernel's dataflow:
  the tiles' totals, their exclusive scan, each tile's scan from its
  prefix) against ``heat_tpu``'s ``cumsum``/``cumprod`` (``jnp.cumsum``/
  ``jnp.cumprod``) and ``torch.cumsum``/``torch.cumprod`` on the same numpy
  inputs: every axis of 1-, 2- and 3-D inputs, axes of 0, 1 and past
  several tiles, float32, float64, int32, int64 and bool. Integers (and
  bool, which accumulates in int64) bit for bit, sums wrapping. Floats:
  a prefix of k terms added in any order lies within
  gamma_k sum_{j<=i} |x_j| of the exact prefix, and a product of k factors
  within gamma_k |prefix| (Higham, 2nd ed., 3.1 and 4.2; gamma_k =
  k u / (1 - k u)); each of the plain version and heat_tpu is held to that
  against a long double reference, so the two lie within twice it of each
  other.
- The CPU route of ``scan_axis`` (one tile: one ``torch.cumsum``), its two
  steps with a carry, the declared route of the types the kernel does not
  take, and the kernel's launch plans at a given SM count.
- The lazy layer: a ``score``-shaped chain (a segment read only by a sum or
  a mean) runs as one segment with the sum as its epilogue; its plan,
  the warm call's ``FUSE_STATS`` deltas equal to heat_tpu's, the sum bit for bit with eager
  on the CPU (the plain epilogue is eager's ``torch.sum``), the mean within
  gamma_n sum|v| / n of eager's (eager's mean takes the moments' shifted
  sums) and both within heat_tpu's tolerances.

The split-axis scan with the ranks' carry across 4 gloo ranks, ragged
layouts included, is ``tests/test_torch_dist.py``'s ``scan_carry`` case.
"""
import functools

import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.core.kernels import KERNEL_STATS, LAUNCHES, scan_axis, scan_axis_plain, scan_begin, scan_finish
from heat_tpu_torch.core.kernels.lazy_fused import reduce_plan, sum_route
from heat_tpu_torch.core.kernels.scan import scan_plan
from heat_tpu_torch.core.lazy import evaluate as tevaluate

SHAPES = [((0,), 0), ((1,), 0), ((29,), 0), ((0, 3), 0), ((0, 3), 1), ((1, 4), 0), ((1, 4), 1), ((23, 5), 0),
          ((23, 5), 1), ((4, 0, 3), 1), ((3, 11, 4), 0), ((3, 11, 4), 1), ((3, 11, 4), 2)]
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.bool_]
TILES = (None, 1, 4, 7)  # rows a tile of the plain version: one tile, and several


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _input(shape, dtype, op, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) > 0.4
    if dtype in (np.int32, np.int64):
        if op == "mul":
            return rng.integers(-3, 4, size=shape).astype(dtype)
        big = 2 ** 30 if dtype == np.int32 else 2 ** 62  # sums wrap
        return rng.integers(-big, big, size=shape).astype(dtype)
    x = rng.normal(size=shape) * 2.0 if op == "add" else 1.0 + 0.5 * rng.normal(size=shape)
    return x.astype(dtype)


def _exact(xn, axis, op):
    """The scan of ``xn`` in long double, and its error scale per element
    (sum_{j<=i} |x_j| for a sum, |prefix| for a product)."""
    w = xn.astype(np.longdouble)
    if op == "add":
        return np.cumsum(w, axis=axis), np.cumsum(np.abs(w), axis=axis)
    ref = np.cumprod(w, axis=axis)
    return ref, np.abs(ref)


def _within_gamma(got, xn, axis, op, factor=1.0):
    ref, scale = _exact(xn, axis, op)
    u = 2.0 ** -24 if xn.dtype == np.float32 else 2.0 ** -53
    k = np.arange(1, xn.shape[axis] + 1, dtype=np.float64).reshape([-1 if d == axis else 1 for d in range(xn.ndim)])
    bound = factor * (k * u / (1 - k * u)) * scale
    gap = np.abs(np.asarray(got).astype(np.longdouble) - ref)
    assert bool((gap <= bound).all()), f"{float(np.max(gap - bound))} past the bound"


@functools.lru_cache(maxsize=None)
def _heat_tpu_scan(shape, axis, dtype, op):
    """heat_tpu's scan of ``_input``'s values (once for every tile size)."""
    xn = _input(shape, dtype, op, seed=len(shape) * 10 + axis)
    res = (htj.cumsum if op == "add" else htj.cumprod)(htj.array(xn), axis)
    return res.dtype.__name__, res.numpy()


@pytest.mark.parametrize("rows", TILES, ids=[f"R{r}" for r in TILES])
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("dtype", DTYPES, ids=[np.dtype(d).name for d in DTYPES])
@pytest.mark.parametrize("shape,axis", SHAPES, ids=[f"{s}-{a}" for s, a in SHAPES])
def test_plain_scan_against_heat_tpu_and_torch(shape, axis, dtype, op, rows):
    xn = _input(shape, dtype, op, seed=len(shape) * 10 + axis)
    x = torch.from_numpy(xn)
    got = scan_axis_plain(x, axis, op, rows_per_tile=rows)
    want_t = (torch.cumsum if op == "add" else torch.cumprod)(x, axis, dtype=torch.int64 if dtype == np.bool_ else x.dtype)
    ref_dtype, ref = _heat_tpu_scan(shape, axis, dtype, op)
    assert got.shape == x.shape and got.dtype == want_t.dtype and str(got.dtype).split(".")[-1] == ref_dtype
    if dtype in (np.float32, np.float64):
        _within_gamma(got.numpy(), xn, axis, op)
        _within_gamma(ref, xn, axis, op)
        _within_gamma(want_t.numpy(), xn, axis, op)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), want_t.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64, torch.bool])
@pytest.mark.parametrize("shape,axis", [((23, 5), 0), ((23, 5), 1), ((3, 11, 4), 1), ((29,), 0)])
def test_cpu_route_is_one_torch_scan(shape, axis, dtype):
    """On the CPU scan_axis runs its plain version with one tile (the same
    bits as torch.cumsum), counted as scan_axis.torch, with no launch."""
    x = torch.from_numpy(_input(shape, np.dtype(str(dtype).split(".")[-1]).type if dtype != torch.bool else np.bool_,
                                "add", seed=5))
    KERNEL_STATS.clear()
    KERNEL_STATS["dispatches"] = 0
    before = LAUNCHES["scan_axis"]
    for op, fn in (("add", torch.cumsum), ("mul", torch.cumprod)):
        got = scan_axis(x, axis, op)
        assert torch.equal(got, fn(x, axis, dtype=torch.int64 if dtype == torch.bool else dtype))
    assert KERNEL_STATS["scan_axis.torch"] == 2 and LAUNCHES["scan_axis"] == before


@pytest.mark.parametrize("rows", TILES, ids=[f"R{r}" for r in TILES])
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_two_steps_with_a_carry(dtype, rows):
    """scan_begin's total is the fold of the axis; scan_finish with a carry,
    and the plain version with it at every tile size, are the scan of the
    carry followed by the rows (integers bit for bit)."""
    xn = _input((3, 19, 4), dtype, "add", seed=8)
    carry = _input((3, 1, 4), dtype, "add", seed=9)
    st = scan_begin(torch.from_numpy(xn), 1, "add")
    got = scan_finish(st, torch.from_numpy(carry))
    full = np.cumsum(np.concatenate([carry, xn], axis=1), axis=1)[:, 1:]
    plain = scan_axis_plain(torch.from_numpy(xn), 1, "add", carry=torch.from_numpy(carry), rows_per_tile=rows)
    if dtype == np.int64:
        for t in (got, plain):
            np.testing.assert_array_equal(t.numpy(), full)
        np.testing.assert_array_equal(st.total.numpy(), xn.sum(axis=1, keepdims=True))
    else:
        for t in (got, plain):
            np.testing.assert_allclose(t.numpy(), full, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(st.total.numpy(), xn.sum(axis=1, keepdims=True), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.complex64, torch.int8, torch.int16,
                                   torch.uint8])
def test_declared_route_types(dtype):
    """The types the kernel does not take run the plain version (one
    torch.cumsum) on any device, counted as scan_axis.torch."""
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 3, size=(30, 7))).to(dtype)
    KERNEL_STATS.clear()
    KERNEL_STATS["dispatches"] = 0
    got = scan_axis(x, 0)
    assert torch.equal(got, torch.cumsum(x, 0, dtype=dtype)) and KERNEL_STATS["scan_axis.torch"] == 1


def test_scan_validation():
    with pytest.raises(ValueError, match="op"):
        scan_axis(torch.ones(3), 0, "max")
    with pytest.raises(IndexError):
        scan_axis(torch.ones(3), 1)
    with pytest.raises(ValueError, match="dimension"):
        scan_axis(torch.ones(()), 0)


@pytest.mark.parametrize("outer,n,inner,dtype,route,mode,lx", [
    (1, 1 << 24, 32, torch.float32, "tiles", 1, 8),    # the split axis of the main path: float4 columns
    (1 << 24, 32, 1, torch.float32, "rows", 0, 1),     # its rows: a thread a row, staged in shared memory
    (1, 1 << 24, 32, torch.int64, "tiles", 1, 16),     # 8-byte types: 2 columns a load
    (1, 1 << 20, 1, torch.float32, "tiles", 2, 1),     # one long row: 4 adjacent rows a pack
    (1, 1 << 20, 3, torch.float32, "tiles", 0, 4),     # 3 columns: one a lane
    (6, 2500, 5, torch.bool, "tiles", 0, 8),
    (1, 1 << 20, 160, torch.float64, "tiles", 1, 32),  # 80 lane groups: 3 chunks of 32
])
def test_scan_plan(outer, n, inner, dtype, route, mode, lx):
    """The launch plan at 132 SMs: the route, the load mode, the lane groups
    a block; tiles of whole steps cover the axis with about four blocks an
    SM (one tile where the other dimensions fill the card)."""
    p = scan_plan(outer, n, inner, dtype, 132)
    assert (p.route, p.mode, p.lx) == (route, mode, lx)
    if route == "rows":
        assert p.tiles == 1 and p.blocks == -(-outer // 256)
        return
    step = (256 // p.lx) * 4
    assert p.rows % step == 0 and (p.tiles - 1) * p.rows < n <= p.tiles * p.rows
    assert p.chunks == -(-p.groups // p.lx) and p.blocks == outer * p.chunks * p.tiles
    assert p.blocks <= 4 * 132 or p.tiles == 1
    unaligned = scan_plan(outer, n, inner, dtype, 132, aligned=False)
    assert unaligned.mode == 0 and (route == "rows" or unaligned.lx == min(32, 1 << (inner - 1).bit_length()))


@pytest.mark.parametrize("outer,n,inner", [(1, 20_000, 32), (1, 70_001, 1), (3, 5000, 8), (2, 300, 1)])
def test_fold_depth_bounds_the_plain_scan_at_the_kernels_tiles(outer, n, inner):
    """ScanPlan.fold_depth d is what the card's checks hold a float32 scan
    to: it counts at least a tile's rows and the tiles, and the plain
    version at the kernel's tiles (at most rows + tiles + 1 roundings on a
    term's path) lies within gamma_m sum_{j<=i} |x_j| of the exact prefix,
    m = min(k, d) for k = i + 1 terms, the float64 reference within its own
    gamma_k (tolerance: gamma_m(2^-24) + gamma_k(2^-53), nothing more)."""
    plan = scan_plan(outer, n, inner, torch.float32, 132)
    d = plan.fold_depth()
    assert d >= plan.rows + plan.tiles
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(outer, n, inner)).astype(np.float32))
    got = scan_axis_plain(x, 1, rows_per_tile=plan.rows).double()
    ref = torch.cumsum(x.double(), 1)
    k = torch.arange(1, n + 1, dtype=torch.float64).reshape(1, -1, 1)
    m = k.clamp(max=d)
    gamma = m * 2.0 ** -24 / (1 - m * 2.0 ** -24) + k * 2.0 ** -53 / (1 - k * 2.0 ** -53)
    assert bool(((got - ref).abs() <= gamma * torch.cumsum(x.double().abs(), 1)).all())


def test_frame_integer_sums_wrap_exactly():
    """The frame's integer run sums (differences of one wrapping scan)
    equal numpy's wrapping sums per run, bit for bit."""
    from heat_tpu_torch.frame._shuffle import _reduce_runs

    rng = np.random.default_rng(4)
    data = rng.integers(-2 ** 30, 2 ** 30, size=(40, 3)).astype(np.int32)
    lengths = np.array([5, 1, 20, 14])
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    got = _reduce_runs("sum", torch.from_numpy(data), torch.from_numpy(starts), torch.from_numpy(lengths))
    want = np.stack([data[s:s + n].sum(axis=0, dtype=np.int32) for s, n in zip(starts, lengths)])
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- the lazy terminal sum
def _chain(ht, kind, axis):
    if kind == "score":
        return lambda x: ht.sum((x * x - 1.0) * 0.5, axis=axis)
    return lambda x: ht.mean(x * 2.0 + 1.0, axis=axis)


def _lazy(ht, fn, *args):
    with ht.lazy():
        return fn(*args)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("kind", ["score", "mean"])
def test_terminal_sum_is_the_segments_epilogue(kind, split, axis, dtype):
    xn = np.random.default_rng(13).standard_normal((24, 8)).astype(dtype)
    chain_t = _chain(htt, kind, axis)
    eager = chain_t(htt.array(xn, split=split))
    tevaluate.PROGRAM_CACHE.clear()
    tevaluate._CSE_CHAINS.clear()
    KERNEL_STATS.clear()
    KERNEL_STATS["dispatches"] = 0
    got = _lazy(htt, chain_t, htt.array(xn, split=split))
    (plan,) = [p for p in tevaluate.PROGRAM_CACHE.values() if hasattr(p, "steps")]
    (step,) = plan.steps
    assert step[0] == "seg" and step[1].reduce is not None and step[1].reduce[2] == (kind == "mean")
    assert KERNEL_STATS.get("lazy_fused.torch") == 1 and "moments_onepass.torch" not in KERNEL_STATS
    assert (got.shape, got.split, got.dtype) == (eager.shape, eager.split, eager.dtype)
    v = (xn.astype(np.float64) * xn - 1.0) * 0.5 if kind == "score" else xn.astype(np.float64) * 2.0 + 1.0
    if kind == "score":  # the plain epilogue is eager's torch.sum
        np.testing.assert_array_equal(got.numpy(), eager.numpy())
    else:  # eager's mean takes the moments' shifted sums: both within gamma_n sum|v| / n, and an ulp
        n = v.size if axis is None else v.shape[axis]
        u = 2.0 ** -24 if dtype == np.float32 else 2.0 ** -53
        bound = 2 * n * u / (1 - n * u) * np.abs(v).sum(axis=axis) / n + 2 * u * np.abs(eager.numpy())
        assert bool((np.abs(got.numpy().astype(np.float64) - eager.numpy()) <= bound).all())
    ref = _lazy(htj, _chain(htj, kind, axis), htj.array(xn, split=split))
    rtol, atol = (1e-5, 1e-5) if dtype == np.float32 else (1e-12, 1e-13)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=atol)
    counts = []  # the warm call's FUSE_STATS deltas (a cold call's depend on the process's earlier chains)
    for ht in (htj, htt):
        x = ht.array(xn, split=split)
        _lazy(ht, _chain(ht, kind, axis), x)
        ht.reset_fuse_stats()
        _lazy(ht, _chain(ht, kind, axis), x)
        counts.append(dict(ht.FUSE_STATS))
    assert counts[1] == counts[0] and counts[0]["fused_dispatches"] == counts[0]["cache_hits"] == 1


@pytest.mark.parametrize("case", ["read_twice", "kept"])
def test_a_root_read_twice_or_kept_is_not_summed_in_its_segment(case):
    """The epilogue takes a root that only the sum reads and that is no
    result: a product also read by another op, or kept alive, is stored
    and summed by the port's own sum."""
    x = htt.array(np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32), split=0)
    tevaluate.PROGRAM_CACHE.clear()
    tevaluate._CSE_CHAINS.clear()
    with htt.lazy():
        p = x * x
        s = htt.sum(p, axis=0)
        if case == "read_twice":
            other = p + 1.0
            del p
    (plan,) = [q for q in tevaluate.PROGRAM_CACHE.values() if hasattr(q, "steps")]
    assert all(item.reduce is None for kind, item in plan.steps if kind == "seg")
    assert [kind for kind, _ in plan.steps] == ["seg", "node"]
    np.testing.assert_array_equal(s.numpy(), htt.sum(x * x, axis=0).numpy())
    if case == "read_twice":
        np.testing.assert_array_equal(other.numpy(), (x * x + 1.0).numpy())


@pytest.mark.parametrize("shape,axis,rows_mode,tx", [
    ((1 << 24, 32), 0, 0, 32),     # score's sum (the tiles route); as lanes, a lane a column, 2 row groups a block
    ((1 << 24, 32), None, 0, 1),   # every axis (the tiles route); as lanes, one lane, 64 row groups
    ((1 << 24, 32), 1, 1, 1),      # rows of 32: a thread a row
    ((5, 3000), 1, 0, 1),          # long rows, few of them: blocks along each row
    ((37, 12, 8), 1, 0, 8),        # a middle axis: 8 lanes
])
def test_terminal_sum_plan(shape, axis, rows_mode, tx):
    """The terminal sum's lanes plan at 132 SMs on a float register file (64
    threads a block, 16 elements a thread a step): the mapping, and chunks
    of whole steps covering the summed axis with about eight blocks an SM;
    sums over every axis, or over the leading axis of rows of 32 columns,
    take the tiles route instead."""
    (outer, r, inner, rows, chunks, lane_tiles, ptx, ty, prm), blocks = reduce_plan(shape, axis, 132)
    assert (prm, ptx) == (rows_mode, tx)
    assert outer * r * inner == int(np.prod(shape))
    assert sum_route(shape, axis) == ("tiles" if shape == (1 << 24, 32) and axis in (0, None) else "lanes")
    if rows_mode:
        assert blocks == -(-outer // 64)
        return
    assert tx * ty <= 64 and rows % (ty * 16) == 0 and (chunks - 1) * rows < r <= chunks * rows
    assert blocks == lane_tiles * outer * chunks and (blocks <= 8 * 132 or chunks == 1)
