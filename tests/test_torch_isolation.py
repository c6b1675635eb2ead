"""heat_tpu_torch stands alone: it imports neither JAX nor heat_tpu, and it
runs on a CUDA card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "heat_tpu", "flax", "optax")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    base = os.path.join(REPO, "heat_tpu_torch")
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_sources_import_no_jax_or_heat_tpu():
    files = list(_port_sources()) + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_dist_worker.py")]
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_cpu_slice_runs_without_jax_in_a_fresh_process():
    code = "\n".join([
        "import sys, numpy as np",
        "import heat_tpu_torch as ht",
        "x = ht.array(np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32), split=0, device='cpu')",
        "z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)",
        "km = ht.cluster.KMeans(n_clusters=2, init=z[:2], max_iter=3, tol=None).fit(z)",
        "assert km.predict(z).shape == (64,) and ht.spatial.cdist(z[:4]).shape == (4, 4)",
        "clf = ht.classification.KNeighborsClassifier(n_neighbors=3).fit(z, km.labels_)",
        "assert (clf.predict(z).numpy() == km.labels_.numpy()).mean() > 0.9",
        "K = ht.spatial.rbf(z, z, sigma=3 ** 0.5) + ht.eye(64, device='cpu')",
        "L = ht.linalg.cholesky(K)",
        "y = ht.ones(64, device='cpu')",
        "alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, y, lower=True), lower=False)",
        "assert float((K @ alpha - y).larray.abs().max()) < 1e-4",
        "assert ht.KERNEL_STATS.get('topk_distance.fallback') == 1 and ht.KERNEL_STATS.get('chol_panel_fused.torch') == 1",
        "q, r = ht.linalg.qr(z)",
        "assert float(ht.linalg.norm(q @ r - z)) < 1e-4 and ht.KERNEL_STATS.get('qr.cholqr2') == 1",
        "m = ht.abs(z) > 1",
        "assert int(ht.sum(ht.where(m, 1, 0))) == int(ht.sum(m)) and ht.argmax(z, axis=0).shape == (3,)",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'heat_tpu', 'flax', 'optax'))",
        "print('LEAKED', bad) if bad else print('CLEAN')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN"), out.stdout


def test_spawned_ranks_import_no_jax():
    """The ranks of tests/test_torch_dist.py's gloo group: what each
    process had imported after running every case."""
    from tests.test_torch_dist import WORLD, run_group

    for rank, res in enumerate(run_group(WORLD)):
        env = res["environment"]
        assert "__error__" not in env, env.get("__error__")
        assert env["leaked"]["value"] == "" and env["rank"]["value"] == rank


def test_default_device_is_the_card():
    assert htt.get_device() == htt.gpu
    assert htt.get_device().device_type == "gpu" and str(htt.get_device()) == "gpu:0"
    assert htt.sanitize_device("cuda:0") == htt.gpu and htt.sanitize_device(torch.device("cpu")) is htt.cpu


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: htt.zeros((2, 2)), lambda: htt.array([1.0, 2.0]), lambda: htt.random.randn(3), lambda: htt.eye(3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert htt.zeros((2, 2), device="cpu").device is htt.cpu  # an explicit CPU request works


def test_use_device_moves_work_to_the_cpu():
    htt.use_device("cpu")
    try:
        x = htt.ones((3, 2))
        assert x.device is htt.cpu and x.larray.device.type == "cpu"
    finally:
        htt.use_device(None)
    assert htt.get_device() == htt.gpu
    with pytest.raises(ValueError):
        htt.use_device("tpu")


def test_dndarray_keeps_its_tensor_device():
    t = torch.arange(4.0)
    x = htt.DNDarray(t, split=0)
    assert x.device is htt.cpu and x.larray is t and np.array_equal(x.numpy(), [0, 1, 2, 3])
