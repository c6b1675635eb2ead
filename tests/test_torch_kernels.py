"""heat_tpu_torch kernels: plain versions against heat_tpu's Pallas kernels,
and the CUDA kernels against their plain versions.

On the CPU each wrapper runs its kernel's plain version; those are held
against ``heat_tpu``'s kernels run in Pallas interpret mode (as heat_tpu's
own tests run them), on the same numpy inputs, at the tolerances heat_tpu
states for these functions (``docs/PERFORMANCE.md``): means 2e-6, M2 2e-4,
labels and counts exact, sums and inertia 1e-5 relative; kNN distances
rtol 1e-4 / atol 1e-5 with indices exact outside near-ties. heat_tpu's
Cholesky kernel cannot run in interpret mode on this JAX (``pl.load`` is
gone), so the plain Cholesky is held against ``np.linalg.cholesky`` in
float64 (tests/test_torch_linalg.py).

Tests marked ``gpu`` need a CUDA card and the CUDA toolkit; the ``cuda``
fixture decides at run time and skips them here. On a card:
``python -m pytest -m gpu tests/test_torch_kernels.py``. This module imports
heat_tpu only inside the ``ref`` fixture, so the gpu tests also run where
JAX is not installed (add ``--noconftest``: tests/conftest.py imports JAX).
"""
import numpy as np
import pytest
import torch

from heat_tpu_torch.core.kernels import (
    KERNEL_STATS,
    KERNELS,
    LAUNCHES,
    MAX_FUSED_N,
    MAX_K,
    _build,
    assign_stats,
    chol_block_size,
    chol_panels,
    cholesky_local,
    chunk_moments,
    dispatch_mode,
    forced_mode,
    knn_tiles,
    lloyd_local,
    lloyd_route,
    merge_moments,
    moments_local,
    nearest_neighbors_local,
    record_dispatch,
    reset_kernel_stats,
)
from heat_tpu_torch.spatial.distance import _quadratic_expand

# kNN: an index may differ from the reference only where the two rows'
# distances (both by the plain version's arithmetic) are this close,
# relative to (d + 1): float32 rounding of (x2 + y2) - 2 xy differs between
# the card, torch's matmul and XLA's dot in the last bits
KNN_TIE_RTOL = 1e-5


def _blobs(seed, n, f, k, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * scale).astype(np.float32)
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    x = (centers[member] + rng.normal(size=(n, f))).astype(np.float32)
    return x, centers


@pytest.fixture
def ref():
    """``(jax.numpy, heat_tpu moments module, heat_tpu lloyd module)``."""
    jnp = pytest.importorskip("jax.numpy")
    from heat_tpu.core.kernels import lloyd, moments

    return jnp, moments, lloyd


@pytest.fixture
def cuda():
    """A CUDA device, or a skip when this machine has none. TF32 is off:
    the plain versions' matrix products run in full float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _knn_ties_only(x, y, d, idx, d0, idx0):
    """Distances agree (rtol 1e-4, atol 1e-5) and indices differ only at
    near-ties: where they differ, the plain version's distances of the two
    rows are within ``KNN_TIE_RTOL``. Returns the number of differing
    entries."""
    np.testing.assert_allclose(np.asarray(d.cpu()), np.asarray(d0.cpu()), rtol=1e-4, atol=1e-5)
    diff = idx.long().cpu() != idx0.long().cpu()
    rows = torch.nonzero(diff.any(dim=1)).flatten().tolist()
    for r0 in range(0, len(rows), 64):
        rr = torch.tensor(rows[r0 : r0 + 64], device=x.device)
        full = _quadratic_expand(x[rr].float(), y.float())
        dk = torch.gather(full, 1, idx[rr].long())
        dp = torch.gather(full, 1, idx0[rr].long())
        assert bool(((dk - dp).abs() <= KNN_TIE_RTOL * (dp.abs() + 1.0)).all()), "indices differ outside near-ties"
    return int(diff.sum())


# ------------------------------------------------------------------ moments
@pytest.mark.parametrize("n,f,n_valid", [(300, 1, 257), (300, 18, 300), (517, 32, 400)])
def test_moments_plain_matches_heat_tpu_kernel(ref, n, f, n_valid):
    jnp, jax_moments, _ = ref
    rng = np.random.default_rng(f)
    x = (rng.normal(size=(n, f)) * 3.0 + 5.0).astype(np.float32)
    cnt_j, mean_j, m2_j = jax_moments.moments_local(jnp.asarray(x), n_valid, interpret=True)
    cnt, mean, m2 = moments_local(torch.from_numpy(x), n_valid)
    assert float(cnt) == float(cnt_j) == n_valid
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(m2.numpy(), np.asarray(m2_j), rtol=2e-4, atol=2e-4)
    x64 = x[:n_valid].astype(np.float64)
    np.testing.assert_allclose(m2.numpy(), ((x64 - x64.mean(0)) ** 2).sum(0), rtol=2e-4)


def test_chunk_and_merge_match_heat_tpu(ref):
    jnp, jax_moments, _ = ref
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 6)).astype(np.float32) + 2.0
    b = rng.normal(size=(40, 6)).astype(np.float32) - 1.0
    ours = merge_moments(*chunk_moments(torch.from_numpy(a)), *chunk_moments(torch.from_numpy(b)))
    theirs = jax_moments.merge_moments(
        *jax_moments.chunk_moments(jnp.asarray(a), 64), *jax_moments.chunk_moments(jnp.asarray(b), 40)
    )
    assert float(ours[0]) == float(theirs[0]) == 104
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(theirs[2]), rtol=2e-4, atol=2e-4)


def test_moments_local_validation():
    with pytest.raises(ValueError):
        moments_local(torch.zeros(4))
    with pytest.raises(ValueError):
        moments_local(torch.zeros((0, 3)))


# -------------------------------------------------------------------- lloyd
@pytest.mark.parametrize("n,f,k,n_valid", [(200, 18, 5, 190), (64, 3, 2, 64), (300, 32, 8, 300)])
def test_lloyd_plain_matches_heat_tpu_kernel(ref, n, f, k, n_valid):
    jnp, _, jax_lloyd = ref
    x, centers = _blobs(n + k, n, f, k)
    sums_j, cnt_j, lab_j, in_j = jax_lloyd.lloyd_local(
        jnp.asarray(x), jnp.asarray(centers), n_valid, interpret=True
    )
    sums, cnt, lab, inertia = lloyd_local(torch.from_numpy(x), torch.from_numpy(centers), n_valid)
    assert lab.dtype == torch.int32 and tuple(sums.shape) == (k, f)
    np.testing.assert_array_equal(lab.numpy()[:n_valid], np.asarray(lab_j)[:n_valid])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5, atol=1e-5 * np.abs(sums.numpy()).max())
    np.testing.assert_allclose(float(inertia), float(in_j), rtol=1e-5)


def test_assign_stats_masks_rows_past_n_valid():
    x, centers = _blobs(5, 50, 4, 3)
    x[45:] = np.inf  # garbage past n_valid must not reach sums, counts or inertia
    sums, cnt, _, inertia = assign_stats(torch.from_numpy(x), torch.from_numpy(centers), 45)
    assert float(cnt.sum()) == 45 and bool(torch.isfinite(sums).all()) and np.isfinite(float(inertia))


def test_lloyd_local_validation():
    with pytest.raises(ValueError):
        lloyd_local(torch.zeros((5, 3)), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        lloyd_local(torch.zeros((0, 3)), torch.zeros((2, 3)))


# -------------------------------------------------------------------- top-k
@pytest.mark.parametrize(
    "n,m,f,k,tile_m",
    [(64, 200, 8, 5, 128), (130, 512, 32, 1, 256), (37, 999, 16, 7, 128), (16, 20, 4, 20, 128), (33, 300, 3, 300, 256)],
)
def test_knn_plain_matches_heat_tpu_kernel(n, m, f, k, tile_m):
    jnp = pytest.importorskip("jax.numpy")
    from heat_tpu.core.kernels import topk_distance as jax_topk

    rng = np.random.default_rng(n + m)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.normal(size=(m, f)).astype(np.float32)
    d_j, i_j = jax_topk.nearest_neighbors(jnp.asarray(x), jnp.asarray(y), k, tile_m=tile_m, interpret=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for tm in (tile_m, 128, 384):  # the plain version's tiling does not change its answer
        d, i = knn_tiles(xt, yt, k, tile_m=tm)
        assert d.dtype == torch.float32 and i.dtype == torch.int32 and tuple(i.shape) == (n, k)
        _knn_ties_only(xt, yt, d, i, torch.from_numpy(np.array(d_j)), torch.from_numpy(np.array(i_j)))
    d, i = nearest_neighbors_local(xt, yt, k)  # the wrapper on a CPU tensor is the plain version
    assert torch.equal(i, knn_tiles(xt, yt, k)[1])


def test_knn_local_validation():
    x, y = torch.zeros((4, 3)), torch.zeros((5, 3))
    for bad_k in (0, 6, -1):
        with pytest.raises(ValueError, match="k="):
            nearest_neighbors_local(x, y, bad_k)
        with pytest.raises(ValueError, match="k="):
            knn_tiles(x, y, bad_k)
    with pytest.raises(ValueError):
        nearest_neighbors_local(torch.zeros((4, 3)), torch.zeros((5, 2)), 1)
    with pytest.raises(ValueError):
        nearest_neighbors_local(torch.zeros(4), torch.zeros((5, 4)), 1)


# ------------------------------------------------------------------- chol
@pytest.mark.parametrize("n,bs", [(1, 8), (8, 8), (129, 128), (300, 64)])
def test_chol_plain_matches_float64(n, bs):
    rng = np.random.default_rng(n)
    g = rng.normal(size=(n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    L = chol_panels(torch.from_numpy(a), bs)
    assert L.dtype == torch.float32 and bool((torch.triu(L, 1) == 0).all())
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(a.astype(np.float64)), rtol=2e-4, atol=2e-5)
    assert torch.equal(cholesky_local(torch.from_numpy(a), bs), L)


def test_chol_block_size_follows_heat_tpu():
    assert [chol_block_size(n) for n in (1, 8, 9, 100, 129, 1024)] == [8, 8, 16, 104, 128, 128]


def test_chol_local_validation():
    with pytest.raises(ValueError, match="square"):
        cholesky_local(torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="MAX_FUSED_N"):
        cholesky_local(torch.zeros((MAX_FUSED_N + 1, MAX_FUSED_N + 1)))


def _indefinite(n, jf, seed=0):
    """An SPD matrix whose pivot ``jf`` is made clearly negative."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n))
    a = g @ g.T / n + np.eye(n)
    a[jf, jf] = -50.0
    return a.astype(np.float32)


@pytest.mark.parametrize("n,jf", [(40, 0), (40, 17), (300, 200)])
def test_chol_plain_nan_from_failing_pivot(n, jf):
    L = chol_panels(torch.from_numpy(_indefinite(n, jf)), chol_block_size(n)).numpy()
    i, j = np.indices((n, n))
    np.testing.assert_array_equal(np.isnan(L), (i >= j) & (j >= jf))
    assert np.isfinite(L[:, :jf]).all() and (np.triu(L, 1) == 0).all()


# ---------------------------------------------------------------- dispatch
def test_registry_and_dispatch_modes():
    assert set(KERNELS) == {"moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused"}
    for spec in KERNELS.values():
        assert spec["comparator"] and spec["roofline"] and spec["replaces"].startswith("heat_tpu/core/kernels/")
    t = torch.zeros(3)
    assert dispatch_mode("lloyd_fused", t) == "torch"
    with forced_mode("lloyd_fused", "torch"):
        assert dispatch_mode("lloyd_fused", t) == "torch"
    with forced_mode("moments_onepass", "cuda"):
        with pytest.raises(ValueError):
            dispatch_mode("moments_onepass", t)  # a CPU tensor never reports the kernel
    with pytest.raises(ValueError):
        with forced_mode("lloyd_fused", "pallas"):
            pass
    with pytest.raises(KeyError):
        dispatch_mode("no_such_kernel", t)


def test_kernel_stats_and_launch_counters():
    reset_kernel_stats()
    record_dispatch("lloyd_fused", "torch")
    moments_local(torch.ones((8, 2)))
    assert KERNEL_STATS == {"dispatches": 1, "lloyd_fused.torch": 1}
    knn_tiles(torch.ones((4, 2)), torch.ones((5, 2)), 2)
    chol_panels(torch.eye(3))
    # the plain versions are no launch
    assert LAUNCHES == {"moments_onepass": 0, "lloyd_fused": 0, "topk_distance": 0, "chol_panel_fused": 0}
    reset_kernel_stats()
    assert KERNEL_STATS == {"dispatches": 0}


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_key_covers_sources_and_flags(monkeypatch):
    key = _build._digest()
    assert key == _build._digest() and len(key) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._digest() != key
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {"moments", "lloyd", "topk_distance", "panel_update"}


def test_build_report_keeps_register_and_spill_lines():
    log = (
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
        "ptxas info    : Function properties for k\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
        "some other compiler chatter\n"
    )
    lines = _build._ptxas_lines(log)
    assert len(lines) == 4 and "0 bytes spill stores" in lines[2] and "40 registers" in lines[3]


# --------------------------------------------------- CUDA kernels (on a card)
@pytest.mark.gpu
@pytest.mark.parametrize("n,f,n_valid", [(4099, 1, 4099), (10_007, 18, 9_000), (20_000, 32, 20_000), (3, 300, 2)])
def test_moments_kernel_matches_plain(cuda, n, f, n_valid):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, f, device=cuda, generator=g) * 3.0 + 5.0
    before = LAUNCHES["moments_onepass"]
    cnt, mean, m2 = moments_local(x, n_valid)
    assert LAUNCHES["moments_onepass"] == before + 1
    cnt0, mean0, m20 = chunk_moments(x, n_valid)
    torch.cuda.synchronize()
    assert float(cnt) == float(cnt0) == n_valid
    torch.testing.assert_close(mean, mean0, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(m2, m20, rtol=2e-4, atol=1e-6)
    again = moments_local(x, n_valid)
    assert bool((again[1] == mean).all() and (again[2] == m2).all())  # no atomics: same bits every run


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,k,n_valid", [(7, 3, 2, 7), (10_007, 18, 5, 9_000), (4_096, 64, 64, 4_096), (3_000, 128, 64, 3_000)])
def test_lloyd_kernel_matches_plain(cuda, n, f, k, n_valid):
    x, centers = _blobs(n, n, f, k)
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(centers).to(cuda)
    before = LAUNCHES["lloyd_fused"]
    sums, cnt, lab, inertia = lloyd_local(xt, ct, n_valid)
    assert LAUNCHES["lloyd_fused"] == before + 1
    sums0, cnt0, lab0, inertia0 = assign_stats(xt, ct, n_valid)
    torch.cuda.synchronize()
    assert bool((lab == lab0).all()) and bool((cnt == cnt0).all())
    torch.testing.assert_close(sums, sums0, rtol=1e-5, atol=1e-5 * float(sums0.abs().max()))
    torch.testing.assert_close(inertia, inertia0, rtol=1e-5, atol=0.0)
    again = lloyd_local(xt, ct, n_valid)
    assert all(bool((a == b).all()) for a, b in zip(again, (sums, cnt, lab, inertia)))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,f,k,n_valid",
    [
        # f past the resident route's 128 columns: the general route
        (3_000, 129, 3, 2_900), (2_000, 160, 16, 2_000), (500, 1_000, 5, 450), (300, 4_097, 3, 250),
        # k * f past 8192: resident while the shared memory holds it, then general
        (4_000, 64, 160, 4_000), (3_000, 64, 400, 2_900),
    ],
)
def test_lloyd_kernel_takes_any_shape(cuda, n, f, k, n_valid):
    """heat_tpu's kernel takes any f and k, and so does the port on a card:
    counts exact, labels equal to the plain version's except where the two
    smallest d2 are within 1e-5 relative, sums 1e-5 and inertia 1e-4
    relative (float32 sums in another order), a rerun bit-identical."""
    x, centers = _blobs(n + f, n, f, k)
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(centers).to(cuda)
    route = lloyd_route(f, k)
    before, routed = LAUNCHES["lloyd_fused"], KERNEL_STATS.get(f"lloyd_fused.{route}", 0)
    sums, cnt, lab, inertia = lloyd_local(xt, ct, n_valid)
    assert LAUNCHES["lloyd_fused"] == before + 1 and KERNEL_STATS[f"lloyd_fused.{route}"] == routed + 1
    sums0, cnt0, lab0, inertia0 = assign_stats(xt, ct, n_valid)
    torch.cuda.synchronize()
    assert lab.dtype == torch.int32 and tuple(lab.shape) == (n,) and tuple(sums.shape) == (k, f)
    assert bool((cnt == cnt0).all())
    two = torch.topk(_quadratic_expand(xt[:n_valid], ct), min(2, k), dim=1, largest=False).values
    near = (two[:, -1] - two[:, 0]) <= 1e-5 * two[:, -1]
    assert not bool(((lab[:n_valid] != lab0[:n_valid]) & ~near).any())
    torch.testing.assert_close(sums, sums0, rtol=1e-5, atol=1e-5 * float(sums0.abs().max()))
    torch.testing.assert_close(inertia, inertia0, rtol=1e-4, atol=0.0)
    again = lloyd_local(xt, ct, n_valid)
    assert all(bool((a == b).all()) for a, b in zip(again, (sums, cnt, lab, inertia)))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,m,f,k",
    [
        (1000, 3000, 7, 1), (37, 999, 16, 7), (50, 50, 5, 50), (300, 5000, 70, 64), (2048, 100_003, 32, 5), (5, 64, 1, 3),
        # lists in the (nseg, n, k) scratch above MAX_K, and k = m
        (300, 5000, 32, 65), (257, 4099, 7, 200), (130, 3000, 32, 1000), (70, 333, 70, 333),
        # n and m off the 128-row query block and the 64-row y tile; f on both copy variants and over one chunk
        (8195, 100_003, 1, 5), (8195, 100_003, 7, 5), (8195, 100_003, 32, 5), (8195, 100_003, 70, 5),
    ],
)
def test_topk_kernel_matches_plain(cuda, n, m, f, k):
    g = torch.Generator(device=cuda).manual_seed(n + m)
    x = torch.randn(n, f, device=cuda, generator=g)
    y = torch.randn(m, f, device=cuda, generator=g)
    before = LAUNCHES["topk_distance"]
    d, i = nearest_neighbors_local(x, y, k)
    assert LAUNCHES["topk_distance"] == before + 1
    d0, i0 = knn_tiles(x, y, k)
    torch.cuda.synchronize()
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and tuple(d.shape) == (n, k)
    assert bool((i >= 0).all() and (i < m).all())
    _knn_ties_only(x, y, d, i, d0, i0)
    again = nearest_neighbors_local(x, y, k)
    assert torch.equal(again[0], d) and torch.equal(again[1], i)  # no atomics: same bits every run


@pytest.mark.gpu
def test_topk_kernel_limits_raise(cuda):
    # k above the shared-memory lists (MAX_K) is no limit on a card: it matches the plain version
    g = torch.Generator(device=cuda).manual_seed(65)
    x, y = torch.randn(8, 4, device=cuda, generator=g), torch.randn(100, 4, device=cuda, generator=g)
    d, i = nearest_neighbors_local(x, y, MAX_K + 1)
    d0, i0 = knn_tiles(x, y, MAX_K + 1)
    _knn_ties_only(x, y, d, i, d0, i0)
    with pytest.raises(ValueError, match="k="):
        nearest_neighbors_local(x, y, 101)


@pytest.mark.gpu
def test_spatial_nearest_neighbors_above_64_on_a_card(cuda):
    # heat_tpu's nearest_neighbors takes any k <= m; so does the port's on a card
    import heat_tpu_torch as ht

    x, _ = _blobs(7, 500, 16, 8)
    y, _ = _blobs(8, 3000, 16, 8)
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    reset_kernel_stats()
    d, i = ht.spatial.nearest_neighbors(ht.array(xt, split=0, device="gpu"), ht.array(yt, device="gpu"), 100)
    assert LAUNCHES["topk_distance"] == 1 and tuple(i.shape) == (500, 100)
    d0, i0 = knn_tiles(xt, yt, 100)
    _knn_ties_only(xt, yt, d.larray, i.larray, d0, i0)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 129, 1000, 1024])
def test_chol_kernel_matches_plain(cuda, n):
    a = torch.from_numpy(_spd(n, n)).to(cuda)
    before = LAUNCHES["chol_panel_fused"]
    L = cholesky_local(a)
    assert LAUNCHES["chol_panel_fused"] == before + 1
    L0 = chol_panels(a, chol_block_size(n))
    torch.cuda.synchronize()
    assert bool((torch.triu(L, 1) == 0).all())
    # float32 sums in another order (fmaf chains vs torch's matmul): relative to max |L|
    torch.testing.assert_close(L, L0, rtol=0.0, atol=2e-5 * float(L0.abs().max()))
    assert torch.equal(cholesky_local(a), L)  # same bits every run


@pytest.mark.gpu
@pytest.mark.parametrize("n,jf", [(40, 17), (300, 200), (1024, 700), (1024, 704)])  # 704: a 32-wide panel's edge
def test_chol_kernel_nan_mask_matches_plain(cuda, n, jf):
    a = torch.from_numpy(_indefinite(n, jf)).to(cuda)
    L = cholesky_local(a)
    L0 = chol_panels(a, chol_block_size(n))
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(L0))
    assert bool(torch.isnan(L[jf:, jf]).all()) and bool((torch.triu(L, 1) == 0).all())


@pytest.mark.gpu
def test_chol_kernel_limits_raise(cuda):
    with pytest.raises(ValueError, match="MAX_FUSED_N"):
        cholesky_local(torch.zeros((MAX_FUSED_N + 1, MAX_FUSED_N + 1), device=cuda))
    with pytest.raises(ValueError, match="square"):
        cholesky_local(torch.zeros((4, 5), device=cuda))
