"""heat_tpu_torch's ``lazy_fused`` binding: the host-side plan of the
Hopper kernel (``csrc/lazy_fused.cu``), on the CPU without a card.

- The dividers the kernel uses in place of ``%`` and ``/`` are exact.
- Each input takes the route its view allows: bulk copies (flat, aligned),
  a tile filled once (a period dividing the tile), per-thread loads (flat
  but unaligned, or strided).
- The largest float and double register files fit the shared memory a
  block may take.
- A segment's plan is built once per layout; a call with other tensors of
  the same layout reuses it.
- Run through a model of the kernel's data flow (:func:`_emulate`: each
  input read by its route, each operand from where the plan says, kept
  slots by their shared-memory offsets), the plan computes what
  ``lazy_fused_plain`` computes, and what ``heat_tpu``'s captured chain
  computes: the same inputs, made with numpy, through both packages.
"""
import importlib

import numpy as np
import pytest
import torch

from heat_tpu_torch.core.kernels import lazy_fused_plain
from heat_tpu_torch.core.kernels.lazy_fused import (
    MAX_IN,
    MAX_INSTR,
    MAX_SLOTS_F64,
    ROUTES,
    SegmentProgram,
    describe,
    divider,
    input_route,
    tile_elems,
)

lf = importlib.import_module("heat_tpu_torch.core.kernels.lazy_fused")  # the module (the package exports the function)
TOP32 = 2 ** 31 - 1  # the largest element index of the kernel's 32-bit route


def _check_divider(ds, bits, seed):
    rng = np.random.default_rng(seed)
    top = 2 ** (bits - 1) - 1
    ds = np.asarray(ds, dtype=np.uint64)
    sample = rng.integers(0, top, size=48, dtype=np.int64).astype(np.uint64)
    i = np.concatenate([np.zeros((ds.size, 1), np.uint64), (ds - 1)[:, None], ds[:, None],
                        np.full((ds.size, 1), top, np.uint64), np.broadcast_to(sample, (ds.size, sample.size))], axis=1)
    magic = np.array([divider(int(d), bits)[0] for d in ds], dtype=np.uint64)[:, None]
    shift = np.array([divider(int(d), bits)[1] for d in ds], dtype=np.uint64)[:, None]
    q = (((i * magic) >> np.uint64(bits)) + i) >> shift
    np.testing.assert_array_equal(q, i // ds[:, None])
    np.testing.assert_array_equal(i - q * ds[:, None], i % ds[:, None])


def test_divider_is_exact_on_32_bit_indices():
    """(magic, shift) gives i // d and i % d for every d <= 4096 and a
    seeded sample of larger d up to the largest extent, at i = 0, d - 1, d,
    2^31 - 1 and a seeded sample (numpy, vectorised)."""
    _check_divider(np.arange(1, 4097), 32, 0)
    big = np.random.default_rng(1).integers(4097, TOP32, size=2000)
    _check_divider(np.concatenate([big, [TOP32, 2 ** 30, 2 ** 30 + 1, 3 << 28]]), 32, 2)
    for d in (1, 2, 3, 7, 4096, TOP32):
        magic, shift = divider(d, 32)
        assert 0 < magic <= 2 ** 32 and (1 << shift) >= d


def test_divider_is_exact_on_64_bit_indices():
    """The 64-bit route's dividers at i up to 2^63 - 1 (python integers)."""
    rng = np.random.default_rng(3)
    top = 2 ** 63 - 1
    for d in [1, 2, 3, 32, 33, 1000, 2 ** 31 - 1, 2 ** 31 + 11, 2 ** 40 + 3] + [int(v) for v in
                                                                            rng.integers(2, 2 ** 62, size=40)]:
        magic, shift = divider(d, 64)
        for i in [0, d - 1, d, top, top - d] + [int(v) for v in rng.integers(0, 2 ** 62, size=20)]:
            q = (((i * magic) >> 64) + i) >> shift
            assert q == i // d and i - q * d == i % d


def _strides(t, shape):
    e = t.expand(shape)
    return (0,) * (4 - len(shape)) + tuple(e.stride())


@pytest.mark.parametrize("view,route", [
    ("flat", "bulk"),            # contiguous at the segment's shape, 16-byte aligned
    ("one", "tile"),             # one element: period 1
    ("row", "tile"),             # a broadcast row (1, 32): period 32 divides the tile
    ("transposed", "strided"),   # a transposed copy: no period, per-thread loads by the dividers
    ("offset", "flat"),          # contiguous at a storage offset of one element: unaligned
    ("column", "strided"),       # a broadcast column (64, 1): period 2048 does not divide 1024
])
def test_input_routes(view, route):
    """Each view's route, on a float and on a double register file, and on
    a sum's lanes route (per-thread loads only)."""
    shape = (64, 32)
    t = {"flat": torch.zeros(shape), "one": torch.zeros(()), "row": torch.zeros(1, 32),
         "transposed": torch.zeros(32, 64).t(), "offset": torch.zeros(64 * 32 + 1)[1:].view(shape),
         "column": torch.zeros(64, 1)}[view]
    full = (1, 1) + shape
    assert input_route(t, _strides(t, shape), full, False, False) == route
    assert input_route(t, _strides(t, shape), full, True, False) == route  # tiles of 512 hold 32 and 1 too
    assert input_route(t, _strides(t, shape), full, False, True) == ("flat" if route in ("bulk", "flat") else
                                                                      "strided")


def _largest(dtype):
    """The most slots a segment may hold: 8 inputs and 32 instructions on
    float registers, 28 slots on double ones, every result kept (each read
    again two instructions on) and 8 outputs."""
    n_in = MAX_IN if dtype == torch.float32 else 1
    n_instr = MAX_INSTR if dtype == torch.float32 else MAX_SLOTS_F64 - 1
    f64 = dtype == torch.float64
    instrs = [("add" if k % 2 else "mul", n_in + k, n_in + k - 1 if k else 0, n_in + k - 2 if k > 1 else -1, 1.5, f64)
              for k in range(n_instr)]
    prog = SegmentProgram(n_in, tuple(instrs), tuple((n_in + n_instr - 1 - k, dtype) for k in range(8)))
    return prog, [torch.zeros(4099, 33, dtype=dtype) for _ in range(n_in)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_largest_register_files_fit(dtype):
    """The tile (1024 float or 512 double elements: 64 threads x 16 or 128 x 4)
    and the shared memory of the largest files stay within the 232,448
    bytes a block may opt into: the deepest ring that fits."""
    prog, inputs = _largest(dtype)
    d = describe(prog, inputs, (4099, 33))
    assert d["tile"] == tile_elems(dtype == torch.float64) == (512 if dtype == torch.float64 else 1024)
    assert d["threads"] * d["per_thread"] == d["tile"]
    assert d["smem"] <= 232448 and d["stages"] >= 2
    assert d["kept_slots"] == len(prog.instrs) - 1  # the last result reaches its outputs from registers
    # the header's budget: the largest file and two staging tiles of 8 inputs
    size = 8 if dtype == torch.float64 else 4
    slots = MAX_SLOTS_F64 if dtype == torch.float64 else MAX_IN + MAX_INSTR
    assert slots * d["tile"] * size + 2 * MAX_IN * d["tile"] * size <= 232448


def test_plan_is_built_once_per_layout():
    """The struct is cached per (program structure, shape, input layouts):
    other tensors of the same layout, or other immediates, reuse it; another
    stride, type or alignment builds anew."""
    prog = SegmentProgram(2, (("sub", 2, 0, 1, 0.0, False), ("mul", 3, 2, -1, 0.5, False)), ((3, torch.float32),))
    other_imm = SegmentProgram(2, (("sub", 2, 0, 1, 0.0, False), ("mul", 3, 2, -1, 2.5, False)),
                               ((3, torch.float32),))
    x, row = torch.zeros(64, 32), torch.zeros(32)
    e = lf._entry(prog, [x, row], (64, 32), False, 132)
    assert lf._entry(prog, [torch.ones(64, 32), torch.ones(32)], (64, 32), False, 132) is e
    assert lf._entry(other_imm, [x, row], (64, 32), False, 132) is e
    assert lf._entry(prog, [torch.zeros(32, 64).t(), row], (64, 32), False, 132) is not e
    assert lf._entry(prog, [x.double(), row], (64, 32), False, 132) is not e
    assert lf._entry(prog, [torch.zeros(2049)[1:].view(64, 32), row], (64, 32), False, 132) is not e
    assert lf._entry(prog, [x, row], (64, 32), 0, 132) is not e


# ------------------------------------------------ a model of the kernel's data flow
def _offsets(plan, k, e):
    """Element offsets of input k at flat indices e: the kernel's lf_offset,
    coordinates by the plan's dividers (32-bit route)."""
    inp = plan.inp[k]
    rem = e.clone()
    off = torch.zeros_like(e)
    for d in range(3, 0, -1):
        if plan.shape[d] == 1:
            continue
        q = (((rem * plan.div[d].magic) >> 32) + rem) >> plan.div[d].shift
        off += (rem - q * plan.shape[d]) * inp.stride[d]
        rem = q
    return off + rem * inp.stride[0]


def _emulate(prog, inputs, shape, reduce=False):
    """The segment as the kernel's plan runs it: each input read by its route
    into its staged tile (the tile route at e mod TILE, as filled once per
    block), every operand from the source the plan names (an immediate, the
    previous result, an input's staged tile or a kept slot at its offset),
    outputs converted from their source; a sum adds the rounded values in
    float64."""
    e_ = lf._entry(prog, inputs, tuple(shape), reduce, 132)
    plan, reg64 = e_.plan, e_.reg64
    assert not plan.idx64
    n, tile = plan.n, tile_elems(reg64)
    e = torch.arange(n, dtype=torch.int64)
    smem = {}
    kinds = {lf._K_F32: torch.float32, lf._K_F64: torch.float64, lf._K_U8: torch.bool}
    for k, t in enumerate(inputs):
        route = ROUTES[plan.inp[k].route]
        assert route == e_.routes[k]
        base = t.storage_offset()
        storage = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size() - base,), (1,))
        idx = e if route in ("bulk", "flat") else _offsets(plan, k, e % tile if route == "tile" else e)
        smem[plan.inp[k].off] = storage[idx]
        assert plan.inp[k].stage == (0 if route == "tile" else e_.plan.inp[k].stage)
    reg_t = torch.float64 if reg64 else torch.float32
    acc = None

    def fetch(src, imm, tt):
        if src.kind == lf._K_IMM:
            return torch.full((n,), imm, dtype=tt)
        if src.kind == lf._K_ACC:
            return acc.to(tt)
        v = smem[src.off]
        assert v.dtype == kinds[src.kind]
        return v.to(tt)

    for k, (op, dst, a, b, imm, f64) in enumerate(prog.instrs):
        q = plan.ins[k]
        if q.inplace:  # in place on the previous result and the immediate, on a float register file
            assert q.a.kind == lf._K_ACC and q.b.kind == lf._K_IMM and op in lf.INPLACE_OPS and not reg64 and not f64
        tt = torch.float64 if q.f64 else torch.float32
        x = fetch(q.a, imm, tt)
        r = lf._TORCH[op](x) if op in lf.UNARY else lf._TORCH[op](x, fetch(q.b, imm, tt))
        acc = r.to(reg_t)
        if q.keep >= 0:
            smem[q.keep] = acc
    outs = []
    for k, (slot, dt) in enumerate(prog.outputs):
        v = fetch(plan.out[k].src, 0.0, reg_t)
        outs.append(v.to(dt).reshape(shape))
    if reduce is not False:
        v = outs[0].double()
        s = v.sum() if reduce is None else v.sum(dim=reduce, keepdim=True)
        return [s.reshape(tuple(1 if reduce is None or d == reduce else x for d, x in enumerate(shape))).to(
            prog.outputs[0][1])]
    return outs


def _random_program(rng, n_in, n_instr, f64_share, out_dt):
    arith = [o for o in lf.OPS if o not in ("gt", "ge", "lt", "le", "eq", "ne", "pow", "log", "sqrt")]
    instrs, slot = [], n_in
    for k in range(n_instr):
        op = str(rng.choice(arith if k < n_instr - 1 else lf.OPS[:4] + ("gt", "le")))
        a = int(rng.integers(max(0, slot - 4), slot))
        b = -1 if op in lf.UNARY or rng.random() < 0.3 else int(rng.integers(0, slot))
        instrs.append((op, slot, a, b, float(rng.uniform(0.5, 2.0)), bool(rng.random() < f64_share)))
        slot += 1
    last_dt = torch.bool if instrs[-1][0] in ("gt", "le") else out_dt
    outputs = ((slot - 1, last_dt), (n_in + n_instr // 2, out_dt), (0, out_dt))
    return SegmentProgram(n_in, tuple(instrs), outputs)


@pytest.mark.parametrize("seed", range(6))
def test_plan_data_flow_equals_plain(seed):
    """Random programs over flat, offset, one-element, row, column and
    transposed inputs of float32, float64 and bool, through the plan's data
    flow: bit for bit the plain version's outputs (the plan's sources,
    kept slots, routes and dividers name the right values)."""
    rng = np.random.default_rng(seed)
    shape = (37, 12, 8) if seed % 2 else (1031, 32)
    dtype = torch.float64 if seed % 3 == 2 else torch.float32
    x = torch.from_numpy(np.abs(rng.normal(size=shape)) + 0.5).to(dtype)
    n = int(np.prod(shape))
    inputs = [x, torch.from_numpy(rng.normal(size=(n + 1,)))[1:].view(shape).float(),
              torch.tensor(float(rng.normal())), torch.from_numpy(rng.normal(size=shape[-1:])).float(),
              torch.from_numpy(rng.random(shape[-2:-1] + (1,)) > 0.5),
              torch.from_numpy(rng.normal(size=shape[::-1])).float().permute(*range(len(shape) - 1, -1, -1))]
    prog = _random_program(rng, len(inputs), 9, 0.3 if dtype == torch.float64 else 0.0, torch.float32)
    got = _emulate(prog, inputs, shape)
    want = lazy_fused_plain(prog, inputs, shape)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shape,axis", [((1031, 32), 0), ((1031, 32), None), ((37, 12, 8), 1), ((999, 12), 0)])
def test_plan_data_flow_of_a_sum(shape, axis):
    """A summed segment's plan (tiles or lanes route) computes the values the
    plain version sums, and its double sum of them is within one float32
    ulp plus 2 gamma_n(2^-53) sum |v| of the plain version's float64 sum."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=shape)).float()
    row = torch.from_numpy(rng.normal(size=shape[-1:])).float()
    prog = SegmentProgram(2, (("mul", 2, 0, 0, 0.0, False), ("sub", 3, 2, 1, 0.0, False),
                              ("mul", 4, 3, -1, 0.5, False)), ((4, torch.float32),))
    (got,) = _emulate(prog, [x, row], shape, axis)
    (vals,) = lazy_fused_plain(prog, [x, row], shape)
    v = vals.double()
    ref = v.sum() if axis is None else v.sum(dim=axis, keepdim=True)
    scale = v.abs().sum() if axis is None else v.abs().sum(dim=axis, keepdim=True)
    terms = v.numel() if axis is None else shape[axis]
    g64 = terms * 2.0 ** -53 / (1 - terms * 2.0 ** -53)
    ref, scale = ref.reshape(got.shape), scale.reshape(got.shape)
    assert bool(((got.double() - ref).abs() <= 2 * 2.0 ** -24 * ref.abs() + 2 * g64 * scale).all())


@pytest.mark.parametrize("chain", ["standardize", "elementwise", "var_norm"])
def test_plan_data_flow_of_heat_tpu_chains(chain):
    """``heat_tpu``'s captured chains (tests/test_lazy.py) and the port's
    segments of the same chains: each segment's plan, run through the
    kernel's data flow, gives heat_tpu's result (the same numpy inputs)."""
    jnp = pytest.importorskip("jax.numpy")
    import heat_tpu as htj
    import heat_tpu_torch as htt
    from heat_tpu_torch.core.lazy import evaluate as lev

    fns = {"standardize": lambda h, a: (a - h.mean(a, axis=0)) / (h.std(a, axis=0) + 1.0),
           "elementwise": lambda h, a: h.exp(-h.abs(a)) * 2.0 + 1.0,
           "var_norm": lambda h, a: a / (h.var(a, axis=0) + 1.0)}
    xn = np.random.default_rng(31).normal(size=(4099, 32)).astype(np.float32)
    with htj.lazy():
        want = fns[chain](htj, htj.array(jnp.asarray(xn), split=0))
    want = want.numpy()
    htt.use_device("cpu")
    calls = []
    orig = lev.lazy_fused

    def rec(prog, inputs, shape, reduce=False):
        calls.append((prog, list(inputs), tuple(shape), reduce))
        return _emulate(prog, inputs, shape, reduce)

    lev.lazy_fused = rec
    try:
        with htt.lazy():
            got = fns[chain](htt, htt.array(torch.from_numpy(xn), split=0))
        got = got.numpy()
    finally:
        lev.lazy_fused = orig
    assert calls
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
