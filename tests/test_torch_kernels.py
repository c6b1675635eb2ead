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
import math

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
    threefry_bits,
    threefry_plain,
)
from heat_tpu_torch.core.kernels.threefry import chunk_layout
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
        moments_local(torch.zeros((5, 0)))
    # no rows (a ragged layout's empty rank): the merge's neutral state, no error
    cnt, mean, m2 = moments_local(torch.zeros((0, 3)))
    assert float(cnt) == 0 and not mean.any() and not m2.any() and mean.shape == (3,)


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
        lloyd_local(torch.zeros((5, 3)), torch.zeros((0, 3)))
    # no rows (a ragged layout's empty rank): zero statistics and no labels, no error
    sums, counts, labels, inertia = lloyd_local(torch.zeros((0, 3)), torch.zeros((2, 3)))
    assert sums.shape == (2, 3) and not sums.any() and not counts.any() and labels.shape == (0,) and float(inertia) == 0


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
    assert set(KERNELS) == {"moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused", "threefry_bits",
                            "lazy_fused", "scan_axis"}
    for name, spec in KERNELS.items():
        assert spec["comparator"] and spec["roofline"]
        # the port's own kernels (random bits, the lazy layer's fused segments, the scan) port no Pallas kernel;
        # every other one names the one it replaces
        own = name in ("threefry_bits", "lazy_fused", "scan_axis")
        assert spec["replaces"].startswith("none: " if own else "heat_tpu/core/kernels/")
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
    threefry_plain((1, 2), (0, 0, 1, 8), "uniform32")
    assert LAUNCHES == {"moments_onepass": 0, "lloyd_fused": 0, "topk_distance": 0, "chol_panel_fused": 0,
                        "threefry_bits": 0, "lazy_fused": 0, "scan_axis": 0}
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
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {"moments", "lloyd", "topk_distance", "panel_update", "threefry",
                                                          "lazy_fused", "scan"}


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bits32", "bits64", "uniform32", "uniform64", "normal32", "normal64"])
@pytest.mark.parametrize(
    "shape,split,chunk", [((1 << 20,), None, None), ((1000, 33), 0, (100, 517)), ((9, 5000), 1, (1250, 1250)),
                          ((3, 4, 7), 1, (2, 2)), ((5, 3), 0, (5, 0))],
)
def test_threefry_kernel_matches_plain(cuda, kind, shape, split, chunk):
    """Bits and uniforms bit-identical to the plain version. Normals within
    2 ulp: both sides round every product and sum on its own and call
    CUDA's log1p and sqrt, so they are expected to be equal too."""
    key = (0x2545F491, 0x6C078965)
    layout = chunk_layout(shape, None, 0, 0) if split is None else chunk_layout(shape, split, *chunk)
    lo, scale = (np.float32(np.nextafter(np.float32(-1), np.float32(0))), 2.0) if kind.startswith("normal") else (0.0, 1.0)
    before = LAUNCHES["threefry_bits"]
    got = threefry_bits(key, layout, kind, cuda, float(lo), scale)
    assert LAUNCHES["threefry_bits"] == before + (1 if got.numel() else 0)
    want = threefry_plain(key, layout, kind, cuda, float(lo), scale)
    torch.cuda.synchronize()
    if kind.startswith("normal"):
        torch.testing.assert_close(got, want, rtol=2 * torch.finfo(got.dtype).eps, atol=0.0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,lo", [("uniform16", 0.0), ("normal16", -1 + 2.0 ** -11), ("uniformbf16", 0.0),
                                     ("normalbf16", -1 + 2.0 ** -8)])
@pytest.mark.parametrize("shape,split,chunk", [((1 << 20,), None, None), ((1000, 33), 0, (100, 517)),
                                               ((9, 5000), 1, (1250, 1250))])
def test_threefry_16_bit_kinds_match_plain_bit_for_bit(cuda, kind, lo, shape, split, chunk):
    """The float16 and bfloat16 kinds bit for bit: the kernel and the plain
    version round to 16 bits after every operation in the same order
    (the normal's float32 erfinv as in the 32-bit kinds)."""
    key = (0x2545F491, 0x6C078965)
    layout = chunk_layout(shape, None, 0, 0) if split is None else chunk_layout(shape, split, *chunk)
    scale = 1.0 if lo == 0.0 else 2.0  # 1 - lo rounds to 2 in both 16-bit types
    got = threefry_bits(key, layout, kind, cuda, lo, scale)
    want = threefry_plain(key, layout, kind, cuda, lo, scale)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_lazy_fused_kernel_equals_plain_on_random_programs(cuda, seed):
    """On a card: random programs over float32/float64/bool inputs with
    broadcast and strided operands, run by the kernel and by its plain
    version, equal bit for bit where no exp/log/pow is involved and within
    2 float32 ulp (1e-15 relative in float64) where one is."""
    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import OPS, UNARY, SegmentProgram

    rng = np.random.default_rng(seed)
    dev = cuda
    shape = (37, 12, 8)
    x = torch.from_numpy(np.abs(rng.normal(size=shape)) + 0.5).to(dev, torch.float32)
    row = torch.from_numpy(rng.normal(size=(8,))).to(dev, torch.float64)
    col = torch.from_numpy(np.abs(rng.normal(size=(12, 1))) + 0.1).to(dev, torch.float32)
    mask = torch.from_numpy(rng.random(shape[1:]) > 0.5).to(dev)
    t = x.transpose(0, 1).contiguous().transpose(0, 1)  # strided, not broadcast
    inputs = [x, row, col, mask, t]
    arith = [o for o in OPS if o not in ("gt", "ge", "lt", "le", "eq", "ne")]
    instrs, slot = [], len(inputs)
    for k in range(6):
        op = str(rng.choice(arith if k < 5 else OPS))
        a = int(rng.integers(0, slot))
        b = -1 if op in UNARY or rng.random() < 0.3 else int(rng.integers(0, slot))
        instrs.append((op, slot, a, b, float(rng.uniform(0.5, 2.0)), bool(rng.random() < 0.3)))
        slot += 1
    out_dt = torch.bool if instrs[-1][0] in ("gt", "ge", "lt", "le", "eq", "ne") else torch.float32
    prog = SegmentProgram(len(inputs), tuple(instrs), ((slot - 2, torch.float32), (slot - 1, out_dt)))
    before = LAUNCHES["lazy_fused"]
    got = lazy_fused(prog, inputs, shape)
    assert LAUNCHES["lazy_fused"] == before + 1
    want = lazy_fused_plain(prog, inputs, shape)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=2 * 2.0 ** -23, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n_in,n_instr", [(torch.float64, 1, 27), (torch.float32, 8, 32)], ids=["f64", "f32"])
def test_lazy_fused_kernel_takes_its_largest_register_file(cuda, dtype, n_in, n_instr):
    """The most slots a segment may hold (28 on double registers, 8 inputs
    and 32 instructions on float ones) launch and equal the plain version
    bit for bit; one slot more is refused before any launch."""
    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram, max_slots

    rng = np.random.default_rng(5)
    inputs = [torch.from_numpy(rng.normal(size=(301, 7))).to(cuda, dtype) for _ in range(n_in)]
    f64 = dtype == torch.float64
    instrs = [("mul" if k % 2 else "add", n_in + k, n_in + k - 1 if k else 0, k % n_in if k % 3 == 0 else -1,
               1.0078125 if k % 2 else 0.5, f64) for k in range(n_instr)]
    prog = SegmentProgram(n_in, tuple(instrs), ((n_in + n_instr - 1, dtype), (n_in + n_instr // 2, dtype)))
    assert n_in + n_instr == max_slots(prog, [t.dtype for t in inputs])
    before = LAUNCHES["lazy_fused"]
    got = lazy_fused(prog, inputs, (301, 7))
    assert LAUNCHES["lazy_fused"] == before + 1
    for g, w in zip(got, lazy_fused_plain(prog, inputs, (301, 7))):
        assert torch.equal(g, w)
    if f64:
        longer = SegmentProgram(n_in, prog.instrs + (("sub", n_in + n_instr, n_in + n_instr - 1, -1, 0.25, True),),
                                ((n_in + n_instr, dtype),))
        with pytest.raises(ValueError, match="28 slots"):
            lazy_fused(longer, inputs, (301, 7))
        assert LAUNCHES["lazy_fused"] == before + 1


def _lazy_case(case, dev):
    """The inputs, shape and program of a layout the kernel routes apart."""
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram

    rng = np.random.default_rng(23)
    if case == "bool_odd":  # a comparison stored as bool, 1001 elements: a tail of 1001 bytes
        x = torch.from_numpy(rng.normal(size=(1001,))).to(dev, torch.float32)
        prog = SegmentProgram(1, (("mul", 1, 0, -1, 3.0, False), ("gt", 2, 1, -1, 0.5, False)),
                              ((2, torch.bool), (1, torch.float32)))
        return [x], (1001,), prog
    shape = (1037, 33) if case == "tail" else (4096, 32)
    x = torch.from_numpy(rng.normal(size=shape)).to(dev, torch.float32)
    if case == "offset":  # storage offset of one element: flat but unaligned, gathered by each thread
        x = torch.from_numpy(rng.normal(size=(shape[0] * shape[1] + 1,))).to(dev, torch.float32)[1:].view(shape)
    row = torch.from_numpy(rng.normal(size=(shape[1],))).to(dev, torch.float32)
    prog = SegmentProgram(2, (("sub", 2, 0, 1, 0.0, False), ("mul", 3, 2, 2, 0.0, False),
                              ("add", 4, 3, -1, 1.0, False), ("div", 5, 2, 4, 0.0, False)),
                          ((5, torch.float32), (3, torch.float32)))
    return [x, row], shape, prog


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tail", "offset", "bool_odd"])
def test_lazy_fused_kernel_routes_match_plain(cuda, case):
    """On a card: a tail tile (1037 x 33 elements), an input at a storage
    offset of one element (the per-thread route), and a bool output of odd
    length each equal the plain version bit for bit, in one launch."""
    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import describe

    inputs, shape, prog = _lazy_case(case, cuda)
    routes = describe(prog, inputs, shape)["routes"]
    assert routes[0] == {"tail": "bulk", "offset": "flat", "bool_odd": "bulk"}[case]
    before = LAUNCHES["lazy_fused"]
    got = lazy_fused(prog, inputs, shape)
    assert LAUNCHES["lazy_fused"] == before + 1
    for g, w in zip(got, lazy_fused_plain(prog, inputs, shape)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("k,rows", [(k, r) for r in (0, 1, 2) for k in (1, 2, 4, 8, 16, 32) if k >= r])
def test_lazy_fused_kernel_sweep_programs_match_plain(cuda, k, rows):
    """On a card: the sweep's programs (``tools/lazy_fused_probe.py``: k
    add/mul instructions, the first ``rows`` adding a broadcast row) at a
    tail size (4099 x 32) equal the plain version bit for bit."""
    import importlib.util
    import pathlib

    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "lazy_fused_probe.py"
    spec = importlib.util.spec_from_file_location("lazy_fused_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    (prog,) = [p for kk, r, p in probe.sweep_programs(SegmentProgram, torch) if (kk, r) == (k, rows)]
    rng = np.random.default_rng(29)
    x = torch.from_numpy(rng.normal(size=(4099, 32))).to(cuda, torch.float32)
    row_inputs = [torch.from_numpy(rng.normal(size=(1, 32))).to(cuda, torch.float32) for _ in range(rows)]
    (got,) = lazy_fused(prog, [x] + row_inputs, (4099, 32))
    (want,) = lazy_fused_plain(prog, [x] + row_inputs, (4099, 32))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("steps", [20, 40], ids=["30ops", "60ops"])
def test_lazy_long_chain_on_a_card_equals_eager(cuda, steps, dtype):
    """Chains of 30 and 60 elementwise ops under ht.lazy() on a card: the
    plan cuts them where the kernel's register file ends (28 slots in
    float64), every segment launches the kernel, and the result equals the
    eager chain bit for bit."""
    import heat_tpu_torch as ht

    def chain(a):
        for i in range(steps):
            a = a * 1.0078125 + 0.5 if i % 2 else a - 0.25
        return a

    xt = torch.from_numpy(np.random.default_rng(17).normal(size=(4099, 33))).to(cuda, dtype)
    eager = chain(ht.array(xt, split=0, device="gpu")).larray
    reset_kernel_stats()
    with ht.lazy():
        got = chain(ht.array(xt, split=0, device="gpu"))
    got = got.larray
    assert LAUNCHES["lazy_fused"] >= 1 and KERNEL_STATS["lazy_fused.cuda"] == LAUNCHES["lazy_fused"]
    assert "lazy_fused.torch" not in KERNEL_STATS
    assert torch.equal(got, eager)


# ------------------------------------------------------ scan_axis (on a card)
# Floats: a prefix of k terms added in any order lies within gamma_k sum_{j<=i} |x_j| of the exact prefix, and a
# product of k factors within gamma_k |prefix| (Higham, 2nd ed., 3.1 and 4.2), gamma_k = k u / (1 - k u); the
# references are float64 (float32 input) or long double (float64 input). Integers wrap, bit for bit.
SCAN_SHAPES = [((1,), 0), ((5,), 0), ((1000,), 0), ((70_001,), 0), ((4099, 3), 0), ((4099, 3), 1), ((3, 5000), 1),
               ((3, 5000), 0), ((37, 12, 8), 0), ((37, 12, 8), 1), ((37, 12, 8), 2), ((20_003, 32), 0),
               ((20_003, 32), 1), ((9, 1), 0), ((1, 64), 1), ((6, 2500, 5), 1)]


def _scan_input(shape, dtype, op, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) > 0.4)
    if dtype in (torch.int32, torch.int64):
        lo, hi = (-3, 4) if op == "mul" else (-(2 ** 30), 2 ** 30)  # sums wrap past 2^31 in int32
        return torch.from_numpy(rng.integers(lo, hi, size=shape)).to(dtype)
    x = rng.normal(size=shape) * 2.0 if op == "add" else 1.0 + 0.01 * rng.normal(size=shape)
    return torch.from_numpy(x).to(dtype)


def _scan_passes(x, axis):
    """The kernels a scan of ``x`` along ``axis`` starts on its card: one
    (a single tile, or a thread a row), or three (the tiles' totals, their
    scan, the tiles' scan)."""
    from heat_tpu_torch.core.kernels.scan import scan_plan

    shape = tuple(x.shape)
    plan = scan_plan(math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]), x.dtype,
                     torch.cuda.get_device_properties(x.device).multi_processor_count)
    return 1 if plan.route == "rows" or plan.tiles == 1 else 3


def _scan_bound_check(got, x, axis, op, what):
    """``got`` (the scan of ``x`` along ``axis``) against an exact-enough
    reference: bit for bit for integers, gamma_k bounds for floats."""
    xn = x.cpu().numpy()
    if not x.dtype.is_floating_point:
        acc = np.int64 if x.dtype == torch.bool else xn.dtype
        ref = (np.cumsum if op == "add" else np.cumprod)(xn.astype(acc), axis=axis, dtype=acc)
        np.testing.assert_array_equal(got.cpu().numpy(), ref, err_msg=what)
        return 0.0
    wide = np.float64 if x.dtype == torch.float32 else np.longdouble
    u = 2.0 ** -24 if x.dtype == torch.float32 else 2.0 ** -53
    k = np.arange(1, xn.shape[axis] + 1, dtype=np.float64).reshape([-1 if d == axis else 1 for d in range(xn.ndim)])
    gamma = k * u / (1 - k * u)
    xw = xn.astype(wide)
    if op == "add":
        ref, scale = np.cumsum(xw, axis=axis), np.cumsum(np.abs(xw), axis=axis)
    else:
        ref = np.cumprod(xw, axis=axis)
        scale = np.abs(ref)
    gap = np.abs(got.cpu().numpy().astype(wide) - ref)
    bound = gamma * scale
    assert bool((gap <= bound).all()), f"{what}: {float(np.max(gap / np.maximum(bound, 1e-300)))} of the bound"
    return float(np.max(gap / np.maximum(bound, np.finfo(np.float64).tiny))) if gap.size else 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64, torch.bool],
                         ids=["f32", "f64", "i32", "i64", "bool"])
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("shape,axis", SCAN_SHAPES, ids=[f"{s}-{a}" for s, a in SCAN_SHAPES])
def test_scan_kernel_matches_plain(cuda, shape, axis, op, dtype):
    """scan_axis on a card launches a kernel a pass of its plan, is
    bit-identical on a second run, equals its plain version bit for bit for integers and bools
    (int64 out), and lies within the gamma_k bounds of the exact scan for
    floats, as the plain version does."""
    from heat_tpu_torch.core.kernels import scan_axis, scan_axis_plain

    x = _scan_input(shape, dtype, op, seed=len(shape) * 7 + axis)
    xd = x.to(cuda)
    before = LAUNCHES["scan_axis"]
    got = scan_axis(xd, axis, op)
    assert LAUNCHES["scan_axis"] == before + _scan_passes(xd, axis)
    assert got.dtype == (torch.int64 if dtype == torch.bool else dtype) and got.shape == x.shape
    assert torch.equal(scan_axis(xd, axis, op), got), "not bit-identical from run to run"
    plain = scan_axis_plain(xd, axis, op, rows_per_tile=97)
    if not dtype.is_floating_point:
        assert torch.equal(got, plain)
    _scan_bound_check(got, x, axis, op, f"kernel {shape} axis {axis}")
    _scan_bound_check(plain, x, axis, op, f"plain {shape} axis {axis}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int64], ids=["f32", "i64"])
@pytest.mark.parametrize("shape,axis", [((20_003, 32), 0), ((70_001,), 0), ((9, 700), 1), ((37, 12, 8), 1)])
def test_scan_kernel_two_steps_with_a_carry(cuda, shape, axis, dtype):
    """scan_begin's total is the fold of the axis, and scan_finish with a
    carry equals the plain version with the same carry (integers bit for
    bit; floats within gamma_{k+1} of the exact scan of the carry and the
    rows)."""
    from heat_tpu_torch.core.kernels import scan_begin, scan_finish, scan_axis_plain

    x = _scan_input(shape, dtype, "add", seed=3)
    xd = x.to(cuda)
    keep = tuple(1 if d == axis else s for d, s in enumerate(shape))
    carry = _scan_input(keep, dtype, "add", seed=4).to(cuda)
    st = scan_begin(xd, axis, "add")
    total = st.total.clone()
    got = scan_finish(st, carry)
    want = scan_axis_plain(xd, axis, "add", carry=carry, rows_per_tile=101)
    both = torch.cat([carry.cpu(), x], dim=axis)
    if dtype == torch.int64:
        assert torch.equal(got, want)
        assert torch.equal(total.cpu(), x.sum(dim=axis, keepdim=True))
    else:
        full = scan_axis_plain(both.double(), axis).narrow(axis, 1, shape[axis])
        k = torch.arange(2, shape[axis] + 2, dtype=torch.float64).reshape(
            [-1 if d == axis else 1 for d in range(len(shape))]) * 2.0 ** -24
        scale = scan_axis_plain(both.double().abs(), axis).narrow(axis, 1, shape[axis])
        assert bool(((got.cpu().double() - full).abs() <= k / (1 - k) * scale).all())
        n = shape[axis]
        assert bool(((total.cpu().double() - x.double().sum(dim=axis, keepdim=True)).abs()
                     <= n * 2.0 ** -24 / (1 - n * 2.0 ** -24) * x.double().abs().sum(dim=axis, keepdim=True)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.complex64, torch.int8, torch.int16,
                                   torch.uint8])
def test_scan_declared_route_types(cuda, dtype):
    """Types the kernel does not take run the plain version on the card,
    decided by type before any launch and counted in
    KERNEL_STATS["scan_axis.torch"]: torch.cumsum's values."""
    from heat_tpu_torch.core.kernels import scan_axis

    x = torch.from_numpy(np.random.default_rng(9).integers(0, 3, size=(300, 7))).to(cuda, dtype)
    reset_kernel_stats()
    got = scan_axis(x, 0, "add")
    assert LAUNCHES["scan_axis"] == 0 and KERNEL_STATS.get("scan_axis.torch") == 1 and "scan_axis.cuda" not in KERNEL_STATS
    assert torch.equal(got, torch.cumsum(x, 0, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((0,), 0), ((0, 5), 0), ((5, 0), 0), ((4, 0, 3), 2), ((3, 4, 0), 1)])
def test_scan_kernel_with_no_elements(cuda, shape, axis):
    """No element: an empty result of the scan's type, its total the
    identity, and no launch."""
    from heat_tpu_torch.core.kernels import scan_axis, scan_begin

    reset_kernel_stats()
    x = torch.zeros(shape, dtype=torch.bool, device=cuda)
    got = scan_axis(x, axis)
    st = scan_begin(x, axis, "mul")
    assert got.shape == x.shape and got.dtype == torch.int64 and LAUNCHES["scan_axis"] == 0
    assert bool((st.total == 1).all()) and st.total.shape == tuple(1 if d == axis else s for d, s in enumerate(shape))


# ------------------------------------------------- the terminal sum (on a card)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape,axis", [((4099, 33), None), ((4099, 33), 0), ((4099, 33), 1), ((37, 12, 8), 1),
                                        ((5, 3000), 1), ((20_000, 32), 0), ((1, 7), None), ((3, 0), 0),
                                        ((4096, 32), None), ((1000, 64), 1), ((999, 12), 0)])
def test_lazy_fused_terminal_sum_matches_plain(cuda, shape, axis, dtype):
    """A segment summed in its epilogue: two launches (the segment, the
    partials' fold), the same bits on a second run, and within one ulp of
    the output's type plus 2 gamma_n(2^-53) sum |v| of the plain version's
    stored values summed in float64 (n the terms a sum adds): the kernel
    adds the same rounded values in double and rounds once."""
    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=shape)).to(cuda, dtype)
    row = torch.from_numpy(rng.normal(size=shape[-1:])).to(cuda, dtype)
    f64 = dtype == torch.float64
    prog = SegmentProgram(2, (("mul", 2, 0, 0, 0.0, f64), ("sub", 3, 2, 1, 0.0, f64), ("mul", 4, 3, -1, 0.5, f64)),
                          ((4, dtype),))
    before = LAUNCHES["lazy_fused"]
    (got,) = lazy_fused(prog, [x, row], shape, reduce=axis)
    n = int(np.prod(shape))
    assert LAUNCHES["lazy_fused"] == before + (2 if n else 0)
    (again,) = lazy_fused(prog, [x, row], shape, reduce=axis)
    assert torch.equal(got, again)
    (want,) = lazy_fused_plain(prog, [x, row], shape, reduce=axis)
    (vals,) = lazy_fused_plain(prog, [x, row], shape)
    assert got.shape == want.shape == tuple(1 if axis is None or d == axis else s for d, s in enumerate(shape))
    terms = n if axis is None else shape[axis]
    u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    g64 = terms * 2.0 ** -53 / (1 - terms * 2.0 ** -53)
    v = vals.double()
    ref = (v.sum() if axis is None else v.sum(dim=axis, keepdim=True)).reshape(got.shape)
    scale = (v.abs().sum() if axis is None else v.abs().sum(dim=axis, keepdim=True)).reshape(got.shape)
    assert bool(((got.double() - ref).abs() <= 2 * u * ref.abs() + 2 * g64 * scale).all())


@pytest.mark.gpu
def test_lazy_score_chain_fuses_its_sum_on_a_card(cuda):
    """The score chain sum((x*x - 1) * 0.5, axis=0) under ht.lazy() on a
    card: one lazy_fused call whose epilogue is the sum (no stored
    product; two launches, the segment and its partials' fold), within
    gamma_n sum|v| of the eager chain."""
    import heat_tpu_torch as ht

    xt = torch.from_numpy(np.random.default_rng(21).normal(size=(40_003, 32))).to(cuda, torch.float32)
    x = ht.array(xt, split=0, device="gpu")
    eager = ht.sum((x * x - 1.0) * 0.5, axis=0).larray
    reset_kernel_stats()
    with ht.lazy():
        got = ht.sum((x * x - 1.0) * 0.5, axis=0)
    got = got.larray
    assert LAUNCHES["lazy_fused"] == 2 and KERNEL_STATS["lazy_fused.cuda"] == 1
    v = ((xt * xt - 1.0) * 0.5).double()
    n = xt.shape[0]
    bound = 2 * n * 2.0 ** -24 / (1 - n * 2.0 ** -24) * v.abs().sum(dim=0)
    assert bool(((got.double() - eager.double()).abs() <= bound).all())
