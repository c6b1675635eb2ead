"""The gradients of heat_tpu_torch's ``ring_attention`` and
``ulysses_attention`` against heat_tpu's (``jax.grad`` through its own ring
and Ulysses schedules) and against dense attention, on the CPU at world
size 1. Across four ranks the same gradients are held in
``tests/test_torch_dist.py`` (case ``attention_grad``).

Tolerances: against heat_tpu, float32, rtol 1e-4 / atol 1e-5 (heat_tpu's
own tests of these gradients take 1e-4 and 2e-4: an online softmax folded
in another order, then its backward); against the port's dense attention in
float64, atol 1e-10 (the same arithmetic in another order, 16 keys).
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _port_grads(fn, arrays, split=None):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*(htt.DNDarray(t, split=split) for t in ts))
    (out.larray ** 2).sum().backward()
    return [t.grad.numpy() for t in ts], out.numpy()


@pytest.mark.parametrize("n, causal", [(13, False), (13, True), (16, True)])
def test_ring_attention_grads_match_heat_tpu(n, causal):
    import jax

    from heat_tpu.parallel.ring_attention import ring_attention as ring_j

    arrays = _qkv((n, 8), seed=17 + n)
    want = jax.jit(jax.grad(lambda *a: (ring_j(*a, htj.get_comm(), causal=causal) ** 2).sum(),
                                argnums=(0, 1, 2)))(*arrays)
    got, _ = _port_grads(lambda q, k, v: htt.parallel.ring_attention(q, k, v, causal=causal), arrays, split=0)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("n, h, causal", [(13, 3, False), (13, 3, True), (16, 4, True)])
def test_ulysses_grads_match_heat_tpu(n, h, causal):
    import jax

    from heat_tpu.parallel import ulysses_attention as ulysses_j

    arrays = _qkv((n, h, 8), seed=19 + n)
    want = jax.jit(jax.grad(lambda *a: (ulysses_j(*a, htj.get_comm(), causal=causal) ** 2).sum(),
                                argnums=(0, 1, 2)))(*arrays)
    got, _ = _port_grads(lambda q, k, v: htt.parallel.ulysses_attention(q, k, v, causal=causal), arrays, split=0)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_dense_in_float64_with_heads(causal):
    arrays = _qkv((3, 16, 8), seed=23, dtype=np.float64)
    got, out = _port_grads(lambda q, k, v: htt.parallel.ring_attention(q, k, v, causal=causal), arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    ref = htt.parallel.attention(*ts, causal=causal)
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=1e-12)
    for g, t in zip(got, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=1e-10)


def test_key_slices_change_no_gradient(monkeypatch):
    """The backward in key slices of 5 keys equals one slice."""
    import sys

    ra = sys.modules["heat_tpu_torch.parallel.ring_attention"]  # the package's name is the function
    arrays = _qkv((2, 16, 4), seed=29, dtype=np.float64)
    whole, _ = _port_grads(lambda q, k, v: htt.parallel.ring_attention(q, k, v, causal=True), arrays)
    monkeypatch.setattr(ra, "_TILE_ELEMS", 2 * 16 * 5)
    sliced, _ = _port_grads(lambda q, k, v: htt.parallel.ring_attention(q, k, v, causal=True), arrays)
    for a, b in zip(whole, sliced):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_training_step_through_ring_attention():
    """heat_tpu's training check: fitting a toy target through the ring
    attention lowers the loss below 0.8 of its start in 30 steps."""
    rng = np.random.default_rng(20)
    n, d = 16, 8
    x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32))
    target = torch.tensor(rng.normal(size=(n, d)).astype(np.float32))
    ws = [torch.eye(d, requires_grad=True) for _ in range(3)]
    opt = torch.optim.SGD(ws, lr=0.1)

    def loss_fn():
        q, k, v = (htt.DNDarray(x @ w, split=0) for w in ws)
        return ((htt.parallel.ring_attention(q, k, v).larray - target) ** 2).mean()

    l0 = float(loss_fn())
    for _ in range(30):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    assert float(loss_fn()) < 0.8 * l0
