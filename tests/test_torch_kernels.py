"""heat_tpu_torch kernels: plain versions against heat_tpu's Pallas kernels,
and the CUDA kernels against their plain versions.

On the CPU each wrapper runs its kernel's plain version; those are held
against ``heat_tpu``'s kernels run in Pallas interpret mode (as heat_tpu's
own tests run them), on the same numpy inputs, at the tolerances heat_tpu
states for these functions (``docs/PERFORMANCE.md``): means 2e-6, M2 2e-4,
labels and counts exact, sums and inertia 1e-5 relative.

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
    MAX_F,
    MAX_KF,
    _build,
    assign_stats,
    chunk_moments,
    dispatch_mode,
    forced_mode,
    lloyd_local,
    merge_moments,
    moments_local,
    record_dispatch,
    reset_kernel_stats,
)


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
    """A CUDA device, or a skip when this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


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


# ---------------------------------------------------------------- dispatch
def test_registry_and_dispatch_modes():
    assert set(KERNELS) == {"moments_onepass", "lloyd_fused"}
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
    assert LAUNCHES == {"moments_onepass": 0, "lloyd_fused": 0}  # the plain version is no launch
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
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {"moments", "lloyd"}


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
def test_lloyd_kernel_limits_raise(cuda):
    with pytest.raises(ValueError, match="k \\* f"):
        lloyd_local(torch.zeros((16, MAX_F + 1), device=cuda), torch.zeros((2, MAX_F + 1), device=cuda))
    with pytest.raises(ValueError, match="k \\* f"):
        lloyd_local(torch.zeros((16, 64), device=cuda), torch.zeros((MAX_KF // 64 + 1, 64), device=cuda))
