"""heat_tpu_torch's ``lloyd_fused`` at any f and k: its two routes' plans on
the CPU, the plain version against ``heat_tpu``'s kernel past the resident
route's limits, and ``KMeans.fit`` at f = 160 against ``heat_tpu``'s.

Route and plan functions are pure Python and are held to the numbers
``csrc/lloyd.cu`` computes (on a card, ``test_resident_geometry_matches_c``).
Tolerances: labels and counts exact, sums 1e-5 and inertia 1e-5 relative
against ``heat_tpu``'s kernel in Pallas interpret mode (float32 sums in
another order); fitted centres 1e-4 relative, labels exact on
well-separated blobs. Tests marked ``gpu`` run the kernels on a card and
skip here: ``python -m pytest -m gpu --noconftest tests/test_torch_lloyd.py``.
"""
import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core.kernels import (
    KERNEL_STATS,
    assign_stats,
    forced_mode,
    lloyd,
    lloyd_general_plan,
    lloyd_local,
    lloyd_resident_plan,
    lloyd_route,
    record_route,
    reset_kernel_stats,
    resident_smem,
)

SMEM = 232448  # the card's opt-in shared memory per block


def _blobs(seed, n, f, k, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * scale).astype(np.float32)
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    return (centers[member] + rng.normal(size=(n, f))).astype(np.float32), centers


@pytest.fixture
def cpu():
    """Run the port on the CPU for one test, then restore the default."""
    htt.use_device("cpu")
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip when this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# ------------------------------------------------------------ routes, plans
@pytest.mark.parametrize(
    "f,k,route",
    [
        (1, 1, "resident"), (1, 5000, "resident"), (32, 8, "resident"), (128, 1, "resident"),
        (128, 24, "resident"), (128, 25, "general"), (129, 1, "general"), (4097, 1, "general"), (4097, 64, "general"),
    ],
)
def test_lloyd_route_at_edge_shapes(f, k, route):
    assert lloyd_route(f, k) == route
    if f <= lloyd._TILE:  # above it the accumulation has no thread per column: general at any size
        assert (resident_smem(f, k) <= SMEM) == (route == "resident")


@pytest.mark.parametrize("f", [1, 3, 4, 31, 32, 33, 64, 100, 128])
def test_lloyd_route_limit_in_k(f):
    """The resident route takes k up to the largest that fits, and no k past it."""
    ks = range(1, 20_001)
    kmax = max(k for k in ks if lloyd_route(f, k) == "resident")
    assert resident_smem(f, kmax) <= SMEM < resident_smem(f, kmax + 1)
    assert all(lloyd_route(f, k) == "general" for k in range(kmax + 1, kmax + 500))


def test_lloyd_route_rejects_empty_shapes():
    with pytest.raises(ValueError):
        lloyd_route(0, 3)
    with pytest.raises(ValueError):
        lloyd_route(3, 0)


def test_resident_smem_counts_the_layout():
    # f = 32, k = 8: 128 float64 inertia slots, 3 stages x 128 rows x 36 floats,
    # 32 x 8 centers + 8 norms, G = min(8192 // 256, 128 // 32) = 4 private (8, 32) sums,
    # 128 tile labels and 4 warps x 8 counts
    assert resident_smem(32, 8) == 8 * 128 + 4 * (3 * 128 * 36 + 32 * 8 + 8 + 4 * 8 * 32) + 4 * (128 + 4 * 8)
    # f % 4 != 0: an odd row stride f | 1 (6 -> 7), G = min(8192 // 6, 128 // 6) = 21
    assert resident_smem(6, 1) == 8 * 128 + 4 * (3 * 128 * 7 + 6 * 8 + 8 + 21 * 6) + 4 * (128 + 4 * 1)


@pytest.mark.parametrize(
    "n,sms,per_sm,want",
    [(1 << 24, 132, 3, 396), (1 << 24, 132, 1, 132), (1000, 132, 3, 8), (1, 132, 2, 1), (128, 132, 2, 1)],
)
def test_lloyd_resident_plan_is_one_wave(n, sms, per_sm, want):
    assert lloyd_resident_plan(n, sms, per_sm) == want


def test_lloyd_resident_plan_refuses_an_empty_card():
    with pytest.raises(RuntimeError, match="blocks per SM"):
        lloyd_resident_plan(1000, 132, 0)


@pytest.mark.parametrize(
    "n,k,f,sms,want",
    [
        (1 << 20, 16, 160, 132, 528),  # four per SM
        (300, 3, 160, 132, 2),  # at least 256 rows a block
        (1, 1, 1, 132, 1),
        (1 << 24, 1024, 1024, 132, 64),  # the scratch cap: 64 x 2^20 floats = 2^26
        (1 << 24, 4096, 4097, 132, 3),
        (1 << 24, 4096, 16385, 132, 1),  # one (k, f) slice alone passes the cap: still one block
    ],
)
def test_lloyd_general_plan(n, k, f, sms, want):
    nb = lloyd_general_plan(n, k, f, sms)
    assert nb == want
    assert nb == 1 or nb * k * f <= lloyd._GENERAL_CAP


def test_record_route_counts_routes_apart_from_dispatches():
    reset_kernel_stats()
    record_route("lloyd_fused", "general")
    record_route("lloyd_fused", "general")
    assert KERNEL_STATS == {"dispatches": 0, "lloyd_fused.general": 2}
    reset_kernel_stats()


# ------------------------------------------- plain version against heat_tpu
@pytest.mark.parametrize("n,f,k,n_valid", [(300, 160, 3, 250), (300, 64, 160, 250), (200, 129, 2, 200)])
def test_lloyd_plain_matches_heat_tpu_past_the_old_limits(n, f, k, n_valid):
    """Shapes the port's card route raised on before (f > 128 or
    k * f > 8192): the plain version, what the CPU runs, against heat_tpu's
    kernel in interpret mode."""
    jnp = pytest.importorskip("jax.numpy")
    from heat_tpu.core.kernels import lloyd as jax_lloyd

    x, centers = _blobs(n + f + k, n, f, k)
    sums_j, cnt_j, lab_j, in_j = jax_lloyd.lloyd_local(jnp.asarray(x), jnp.asarray(centers), n_valid, interpret=True)
    sums, cnt, lab, inertia = lloyd_local(torch.from_numpy(x), torch.from_numpy(centers), n_valid)
    assert lab.dtype == torch.int32 and tuple(lab.shape) == (n,) and tuple(sums.shape) == (k, f)
    np.testing.assert_array_equal(lab.numpy()[:n_valid], np.asarray(lab_j)[:n_valid])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5, atol=1e-5 * np.abs(sums.numpy()).max())
    np.testing.assert_allclose(float(inertia), float(in_j), rtol=1e-5)


def test_kmeans_fit_at_f160_matches_heat_tpu(cpu):
    htj = pytest.importorskip("heat_tpu")
    x_np, _ = _blobs(11, 240, 160, 4)
    kmj = htj.cluster.KMeans(n_clusters=4, init=htj.array(x_np[:4]), max_iter=8, tol=None).fit(htj.array(x_np, split=0))
    kmt = htt.cluster.KMeans(n_clusters=4, init=htt.array(x_np[:4]), max_iter=8, tol=None).fit(htt.array(x_np, split=0))
    assert kmt.n_iter_ == kmj.n_iter_ == 8
    np.testing.assert_array_equal(kmt.labels_.numpy(), kmj.labels_.numpy())
    cj = kmj.cluster_centers_.numpy()
    np.testing.assert_allclose(kmt.cluster_centers_.numpy(), cj, rtol=1e-4, atol=1e-4 * np.abs(cj).max())
    np.testing.assert_allclose(kmt.inertia_, kmj.inertia_, rtol=1e-4)


# ------------------------------------------------------------------ on a card
@pytest.mark.gpu
def test_resident_geometry_matches_c(cuda):
    lib = lloyd._library()
    assert lib.lloyd_tile() == lloyd._TILE and lib.lloyd_stages() == lloyd._STAGES
    for f in (1, 3, 4, 32, 33, 64, 100, 128, 129, 160):
        for k in (1, 8, 24, 25, 64, 160, 700, 5000):
            want = resident_smem(f, k) if lloyd_route(f, k) == "resident" else -1
            assert lib.lloyd_resident_smem(f, k) == want, (f, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,k", [(1000, 32, 8), (999, 6, 5), (130, 128, 24)])
def test_resident_route_on_unaligned_rows(cuda, n, f, k):
    """x one float past a 16-byte boundary: the 4-byte copy variant."""
    x, centers = _blobs(n, n, f, k)
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.float32), x.ravel()])).to(cuda)
    xt = buf[1:].reshape(n, f)  # contiguous, 4 bytes past the allocation's alignment
    assert xt.data_ptr() % 16 == 4
    ct = torch.from_numpy(centers).to(cuda)
    assert lloyd_route(f, k) == "resident"
    sums, cnt, lab, inertia = lloyd_local(xt, ct)
    sums0, cnt0, lab0, inertia0 = assign_stats(xt, ct)
    torch.cuda.synchronize()
    assert bool((lab == lab0).all()) and bool((cnt == cnt0).all())
    torch.testing.assert_close(sums, sums0, rtol=1e-5, atol=1e-5 * float(sums0.abs().max()))
    torch.testing.assert_close(inertia, inertia0, rtol=1e-4, atol=0.0)


@pytest.mark.gpu
def test_kmeans_fit_at_f160_on_a_card(cuda):
    """The general route drives the whole fit, and agrees with the plain fit."""
    x_np, _ = _blobs(5, 20_000, 160, 16)
    x = htt.array(torch.from_numpy(x_np).to(cuda), split=0)
    reset_kernel_stats()
    km = htt.cluster.KMeans(n_clusters=16, init=x[:16], max_iter=6, tol=None).fit(x)
    assert KERNEL_STATS.get("lloyd_fused.general") == 7 and "lloyd_fused.resident" not in KERNEL_STATS
    with forced_mode("lloyd_fused", "torch"):
        km0 = htt.cluster.KMeans(n_clusters=16, init=x[:16], max_iter=6, tol=None).fit(x)
    c0 = km0.cluster_centers_.larray
    assert float((km.cluster_centers_.larray - c0).abs().max()) <= 1e-4 * float(c0.abs().max())
    assert bool((km.labels_.larray == km0.labels_.larray).all())
    np.testing.assert_allclose(km.inertia_, km0.inertia_, rtol=1e-4)
