"""heat_tpu_torch's ``nn`` and ``optim`` against heat_tpu, on the CPU: the
names, the ``compat`` layers with weights carried by ``convert.py``, the
learning-rate schedules, the vision transforms, ``DataParallel``,
``DataParallelOptimizer`` and DASO's schedule.

heat_tpu runs under ``comm_context(SELF)`` (world size 1, as the port here).

Tolerances:
- layers: outputs rtol 1e-5 / atol 1e-6 (float32 products in another
  order; LayerNorm/BatchNorm a few ulp of their normalized values);
- schedules: per-step learning rates rtol 1e-6 (optax computes in float32);
- transforms: exact;
- DataParallel (the MLP of tests/test_dp_equivalence.py, SGD with momentum
  0.9 and Adam): parameters after every step rtol 1e-5 / atol 1e-6 (the
  only difference is float32 rounding in another order, which a few steps
  do not amplify at these learning rates), losses rtol 1e-5;
- DASO: the schedule fields exactly; parameters rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch import convert

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_apply(module, x, seed=0, **kw):
    """(variables, output) of a flax module on ``x``, each one compiled program."""
    import jax
    import jax.numpy as jnp

    variables = jax.jit(lambda k, a: module.init(k, a, **kw))(jax.random.PRNGKey(seed), jnp.asarray(x))
    return variables, np.asarray(jax.jit(lambda v, a: module.apply(v, a, **kw))(variables, jnp.asarray(x)))


# -------------------------------------------------------------------- names
def test_nn_names_are_torchs():
    assert set(htt.nn.compat.__all__) == set(htj.nn.compat.__all__) and len(htt.nn.compat.__all__) == 21
    for name in htt.nn.compat.__all__:
        assert getattr(htt.nn, name) is getattr(torch.nn, name), name
    assert htt.nn.Sequential is torch.nn.Sequential and htt.nn.Module is torch.nn.Module
    assert htt.nn.functional.relu is torch.nn.functional.relu
    assert htt.nn.lr_scheduler.StepLR is torch.optim.lr_scheduler.StepLR
    assert htt.optim.SGD is torch.optim.SGD and htt.optim.Adam is torch.optim.Adam
    assert htt.optim.lr_scheduler is htt.nn.lr_scheduler
    for mod in (htt.nn, htt.nn.functional, htt.nn.lr_scheduler, htt.optim):
        with pytest.raises(AttributeError):
            getattr(mod, "no_such_name")
    # the torch conventions the reference's shims exist for
    ln = htt.nn.LayerNorm(512)
    assert ln.normalized_shape == (512,) and ln.eps == 1e-5
    bn = htt.nn.BatchNorm1d(3, momentum=0.1)
    x = torch.arange(12.0).reshape(4, 3)
    bn(x)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.mean(0).numpy(), rtol=1e-6)


def test_optim_utils_plateau_is_heat_tpus():
    t, j = htt.optim.DetectMetricPlateau(patience=2, threshold=0.1), htj.optim.DetectMetricPlateau(patience=2, threshold=0.1)
    for m in (1.0, 0.95, 0.94, 0.93, 0.5, 0.49, 0.48, 0.47, 0.47):
        assert t.test_if_improving(m) == j.test_if_improving(m)
        assert t.get_state() == j.get_state()
    t.set_state({"best": 3.0})
    assert t.best == 3.0
    with pytest.raises(ValueError):
        htt.optim.DetectMetricPlateau(mode="sideways")


# ------------------------------------------------------------------- layers
def test_linear_conv_embedding_and_norms_with_carried_weights():
    """One flax module of heat_tpu's compat layers (Dense, Conv, Embed, LayerNorm, BatchNorm in inference with
    random statistics) and the port's torch layers in the same order, its weights carried by flax_to_state_dict."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    compat = htj.nn.compat

    class Layers(fnn.Module):
        @fnn.compact
        def __call__(self, x, img, ids):
            return (compat.Linear(7, 4)(x), compat.Conv2d(3, 5, kernel_size=3, stride=2, padding=1)(img),
                    compat.Embedding(10, 6)(ids), compat.LayerNorm(7)(x),
                    compat.BatchNorm1d(7)(x, use_running_average=True))

    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    img = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)  # NHWC for flax, NCHW for torch
    ids = rng.integers(0, 10, size=(3, 4))
    module = Layers()
    v = _tree_np(jax.jit(module.init)(jax.random.PRNGKey(0), x, img, ids))
    for name in ("LayerNorm_0", "BatchNorm_0"):
        v["params"][name] = {"scale": rng.uniform(0.5, 2, 7).astype(np.float32),
                             "bias": rng.normal(size=7).astype(np.float32)}
    v["batch_stats"]["BatchNorm_0"] = {"mean": rng.normal(size=7).astype(np.float32),
                                       "var": rng.uniform(0.5, 2, 7).astype(np.float32)}
    want = [np.asarray(w) for w in jax.jit(module.apply)(jax.tree_util.tree_map(jnp.asarray, v), x, img, ids)]
    layers = torch.nn.ModuleList([htt.nn.Linear(7, 4), htt.nn.Conv2d(3, 5, kernel_size=3, stride=2, padding=1),
                                  htt.nn.Embedding(10, 6), htt.nn.LayerNorm(7), htt.nn.BatchNorm1d(7)]).eval()
    layers.load_state_dict(convert.flax_to_state_dict(v, layers), strict=False)
    got = [layers[0](torch.tensor(x)), layers[1](torch.tensor(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           layers[2](torch.tensor(ids)), layers[3](torch.tensor(x)), layers[4](torch.tensor(x))]
    for name, g, w in zip(("Linear", "Conv2d", "Embedding", "LayerNorm", "BatchNorm1d"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax", "Flatten"])
def test_activations(name):
    x = np.random.default_rng(1).normal(size=(3, 2, 4)).astype(np.float32)
    _, want = _flax_apply(getattr(htj.nn.compat, name)(), x)
    layer = getattr(htt.nn, name)(dim=-1) if name in ("Softmax", "LogSoftmax") else getattr(htt.nn, name)()
    # torch's GELU is the exact erf form; flax's default is the tanh approximation
    if name == "GELU":
        layer = htt.nn.GELU(approximate="tanh")
    np.testing.assert_allclose(layer(torch.tensor(x)).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "CrossEntropyLoss", "NLLLoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses(name, reduction):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(6, 4)).astype(np.float32)
    target = rng.integers(0, 4, size=6) if name in ("CrossEntropyLoss", "NLLLoss") else rng.normal(
        size=(6, 4)).astype(np.float32)
    want = np.asarray(getattr(htj.nn.compat, name)(reduction=reduction)(pred, target))
    got = getattr(htt.nn, name)(reduction=reduction)(torch.tensor(pred), torch.tensor(target))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- schedules
SCHEDULES = {
    "StepLR": (lambda o: htt.nn.lr_scheduler.StepLR(o, 3, 0.5), lambda s, lr: s(lr, 3, 0.5, staircase=True)),
    "ExponentialLR": (lambda o: htt.nn.lr_scheduler.ExponentialLR(o, 0.9), lambda s, lr: s(lr, 1, 0.9)),
    "CosineAnnealingLR": (lambda o: htt.nn.lr_scheduler.CosineAnnealingLR(o, 10), lambda s, lr: s(lr, 10)),
    "MultiStepLR": (lambda o: htt.nn.lr_scheduler.MultiStepLR(o, [3, 7], 0.1), lambda s, lr: s(lr, {3: 0.1, 7: 0.1})),
    "LinearLR": (lambda o: htt.nn.lr_scheduler.LinearLR(o, 0.5, 1.0, 4), lambda s, lr: s(lr * 0.5, lr, 4)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_give_heat_tpus_rates(name):
    make_t, make_j = SCHEDULES[name]
    lr = 0.1
    steps = 11  # past T_max torch's cosine rises again, optax's stays at 0
    want = np.asarray(make_j(getattr(htj.nn.lr_scheduler, name), lr)(np.arange(steps)))
    p = torch.nn.Parameter(torch.zeros(1))
    opt = htt.optim.SGD([p], lr=lr)
    sched_t = make_t(opt)
    for step in range(steps):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want[step], rtol=1e-6, err_msg=f"step {step}")
        opt.step()
        sched_t.step()


# --------------------------------------------------------------- transforms
def test_vision_transforms_exact():
    img = np.random.default_rng(3).integers(0, 256, size=(5, 4, 3), dtype=np.uint8)
    for pkg_t, pkg_j in ((htt.nn.vision_transforms, htj.nn.vision_transforms),):
        tt = pkg_t.Compose([pkg_t.ToTensor(), pkg_t.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))])
        tj = pkg_j.Compose([pkg_j.ToTensor(), pkg_j.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))])
        np.testing.assert_array_equal(tt(img).numpy(), np.asarray(tj(img)))
        np.testing.assert_array_equal(pkg_t.ToTensor()(img[:, :, 0]).numpy(), np.asarray(pkg_j.ToTensor()(img[:, :, 0])))
        np.testing.assert_array_equal(pkg_t.ToTensor()(torch.tensor(img)).numpy(), np.asarray(pkg_j.ToTensor()(img)))


# ------------------------------------------------------------- DataParallel
def _mlp_pair(seed=3):
    """heat_tpu's MLP of tests/test_dp_equivalence.py, and the port's with its weights."""
    import flax.linen as fnn
    import jax.numpy as jnp

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Dense(16)(x)
            x = fnn.tanh(x)
            return fnn.Dense(1)(x)

    port = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    return MLP(), port, jnp


def _mse_j(pred, target):
    import jax.numpy as jnp

    return jnp.mean((pred - target) ** 2)


def _mse_t(pred, target):
    return torch.mean((pred - target) ** 2)


@pytest.mark.parametrize("opt, batch", [("sgd_momentum", 28), ("adam", 32)])
def test_data_parallel_tracks_heat_tpu(opt, batch):
    import optax

    model_j, model_t, jnp = _mlp_pair()
    tx = optax.sgd(0.05, momentum=0.9) if opt == "sgd_momentum" else optax.adam(1e-2)
    dj = htj.nn.DataParallel(model_j, optimizer=tx, seed=3)
    dj.init(jnp.zeros((1, 8)))
    torch_opt = (torch.optim.SGD(model_t.parameters(), lr=0.05, momentum=0.9) if opt == "sgd_momentum"
                 else torch.optim.Adam(model_t.parameters(), lr=1e-2))
    dpo = htt.optim.DataParallelOptimizer(torch_opt)
    dt = htt.nn.DataParallel(model_t, optimizer=dpo)
    dt.load_state_dict(convert.dp_state_from_heat_tpu(dj.state_dict(), dt))
    rng = np.random.default_rng(7)
    for step in range(6):
        xb, yb = rng.normal(size=(batch, 8)).astype(np.float32), rng.normal(size=(batch, 1)).astype(np.float32)
        lj = float(dj.train_step(_mse_j, htj.array(xb, split=0), htj.array(yb, split=0)))
        lt = dpo.step(_mse_t, htt.array(xb, split=0), htt.array(yb, split=0))
        assert lt.ndim == 0 and lt.requires_grad is False
        np.testing.assert_allclose(float(lt), lj, rtol=RTOL)
        want = convert.dp_state_from_heat_tpu(dj.state_dict(), dt)
        got = dt.state_dict()
        for key in [k for k in want if k.startswith("params.")]:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=f"step {step} {key}")
    assert dpo.batches_completed == 6 and dpo.state_dict() == {"batches_completed": 6}
    # the optimizer's state carried both ways: the port's momentum / moments equal heat_tpu's
    want = convert.dp_state_from_heat_tpu(dj.state_dict(), dt)
    for key in [k for k in want if k.startswith("opt.")]:
        np.testing.assert_allclose(dt.state_dict()[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_data_parallel_loss_and_grad_forward_and_state():
    model_j, model_t, jnp = _mlp_pair()
    import jax

    dj = htj.nn.DataParallel(model_j, seed=1)
    dj.init(jnp.zeros((1, 8)))
    dt = htt.nn.DataParallel(model_t)
    dt.load_state_dict(convert.dp_state_from_heat_tpu(dj.state_dict(), dt))
    rng = np.random.default_rng(8)
    xb, yb = rng.normal(size=(12, 8)).astype(np.float32), rng.normal(size=(12, 1)).astype(np.float32)
    lj, gj = dj.loss_and_grad(_mse_j, htj.array(xb, split=0), htj.array(yb, split=0))
    lt, gt = dt.loss_and_grad(_mse_t, htt.array(xb, split=0), htt.array(yb, split=0))
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    gj = jax.tree_util.tree_map(np.asarray, gj)["params"]
    np.testing.assert_allclose(gt["0.weight"].numpy(), gj["Dense_0"]["kernel"].T, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gt["2.bias"].numpy(), gj["Dense_1"]["bias"], rtol=1e-4, atol=1e-6)
    out_t, out_j = dt(htt.array(xb, split=0)), dj(htj.array(xb, split=0))
    assert out_t.gshape == out_j.gshape and out_t.split == out_j.split
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j.numpy()), rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match="without an optimizer"):
        dt.train_step(_mse_t, htt.array(xb), htt.array(yb))
    # a supervised fit without an optimizer: the RuntimeError's probe finds the card healthy, so it surfaces
    with pytest.raises(RuntimeError, match="without an optimizer"):
        dt.fit(_mse_t, htt.array(xb), htt.array(yb), 2, supervisor=htt.resilience.Supervisor())
    # init re-seeds: the same parameters from the same seed, others from another
    a = {k: v.detach().clone() for k, v in dt.init().items()}
    b = dt.init()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(htt.nn.DataParallel(model_t, seed=5).init()["0.weight"], a["0.weight"])
    assert dt.eval() is dt and not dt.module.training and dt.train().module.training
    assert htt.nn.DataParallelMultiGPU.__mro__[1] is htt.nn.DataParallel


def test_data_parallel_state_dict_round_trip_and_fit():
    _, model_t, _ = _mlp_pair()
    opt = torch.optim.SGD(model_t.parameters(), lr=0.05, momentum=0.9)
    dt = htt.nn.DataParallel(model_t, None, opt)
    rng = np.random.default_rng(9)
    xb, yb = htt.array(rng.normal(size=(16, 8)).astype(np.float32)), htt.array(rng.normal(size=(16, 1)).astype(np.float32))
    dt.fit(_mse_t, xb, yb, 3)
    saved = dt.state_dict()
    dt.fit(_mse_t, xb, yb, 2)
    after = dt.state_dict()
    dt.load_state_dict(saved).fit(_mse_t, xb, yb, 2)
    for k, v in dt.state_dict().items():
        np.testing.assert_array_equal(v, after[k], err_msg=k)
    # the (module, optimizer, comm) order
    assert htt.nn.DataParallel(model_t, opt, None)._optimizer is opt


def test_global_batchnorm_is_torchs_at_world_size_1():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    ref = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    ref.load_state_dict(model.state_dict())
    dt = htt.nn.DataParallel(model)
    assert isinstance(dt.module[1], htt.nn.data_parallel.GlobalBatchNorm) and isinstance(dt.module[1], torch.nn.BatchNorm1d)
    assert dt.module[1].weight is model[1].weight  # the same parameters: an optimizer built before stays valid
    x = torch.randn(10, 4)
    np.testing.assert_array_equal(dt(htt.array(x.numpy(), split=0)).numpy(), ref(x).detach().numpy())
    np.testing.assert_array_equal(dt.module[1].running_mean.numpy(), ref[1].running_mean.numpy())


# ---------------------------------------------------------------------- DASO
LOSSES = [1.0, 0.8, 0.79, 0.785, 0.784, 0.5, 0.49, 0.489, 0.488, 0.4879, 0.48, 0.3]


def test_daso_schedule_fields_follow_heat_tpus():
    import optax

    model = torch.nn.Linear(3, 1)
    t = htt.optim.DASO(torch.optim.SGD(model.parameters(), lr=0.1), total_epochs=12, warmup_epochs=2,
                       cooldown_epochs=2, max_global_skips=8)
    j = htj.optim.DASO(optax.sgd(0.1), total_epochs=12, warmup_epochs=2, cooldown_epochs=2, max_global_skips=8)
    for loss in LOSSES:
        t.epoch_loss_logic(loss)
        j.epoch_loss_logic(loss)
        assert (t.global_skip, t.batches_to_wait, t.epoch) == (j.global_skip, j.batches_to_wait, j.epoch)
        assert t.stability.get_state() == j.stability.get_state()


def test_daso_one_group_is_plain_sgd_and_keeps_state():
    """At world size 1 there is one group: DASO steps are the local
    optimizer's, and state_dict/load_state_dict round-trip the schedule."""
    torch.manual_seed(1)
    model, ref = torch.nn.Linear(3, 1), torch.nn.Linear(3, 1)
    ref.load_state_dict(model.state_dict())
    daso = htt.optim.DASO(torch.optim.SGD(model.parameters(), lr=0.1), total_epochs=4)
    model = daso.init(model, htt.parallel.make_hierarchical_mesh(n_slow=1))
    ropt = torch.optim.SGD(ref.parameters(), lr=0.1)
    rng = np.random.default_rng(10)

    def loss_fn(m, xb, yb):
        return torch.mean((m(xb) - yb) ** 2)

    for _ in range(5):
        xb, yb = torch.tensor(rng.normal(size=(6, 3)), dtype=torch.float32), torch.tensor(
            rng.normal(size=(6, 1)), dtype=torch.float32)
        model, loss = daso.step(loss_fn, model, xb, yb)
        ropt.zero_grad()
        rl = loss_fn(ref, xb, yb)
        rl.backward()
        ropt.step()
        np.testing.assert_allclose(float(loss), float(rl), rtol=RTOL)
        for (n, p), q in zip(model.named_parameters(), ref.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=RTOL, atol=ATOL, err_msg=n)
    daso.epoch_loss_logic(0.5)
    d = daso.state_dict(model)
    assert {"global_skip", "batches_to_wait", "epoch", "batch", "params.weight"} <= set(d) and d["batch"] == 5
    other = htt.optim.DASO(torch.optim.SGD(model.parameters(), lr=0.1), total_epochs=4)
    other.load_state_dict(d)
    assert (other.global_skip, other.batches_to_wait, other.epoch, other._batch) == (
        daso.global_skip, daso.batches_to_wait, daso.epoch, 5)
    final = daso.consolidated_params(model)
    np.testing.assert_array_equal(final["weight"].numpy(), model.weight.detach().numpy())
    with pytest.raises(RuntimeError, match="init must be called"):
        htt.optim.DASO(torch.optim.SGD(model.parameters(), lr=0.1), total_epochs=4).step(loss_fn, model, xb, yb)
