"""Numerics of a 3xTF32 product for the kNN distances, and the host-side
launch plans of the two kernels redesigned for Hopper, on the CPU.

3xTF32 computes x·yᵀ as three TF32 products: each operand v splits into
hi = tf32(v) and lo = tf32(v − hi), rounded to nearest with ties away from
zero (``cvt.rna.tf32.f32``), and lo·hi + hi·lo is summed before hi·hi.
These tests emulate it with plain torch (tf32 rounding by bit mask,
IEEE float32 sums) and hold the neighbours it gives against the float32
plain version :func:`knn_tiles` at the tolerances ``chip_smoke.py``
applies on the card: distances within rtol 1e-4 / atol 1e-5, indices
equal except at near-ties (the plain version's distances of the two rows
within 1e-5 of d + 1). They also show why one TF32 product is not
enough. On the card, tensor cores summing the same products did not hold
the tolerance at the kNN path's full size (2^13 queries x 2^22 rows), so
``csrc/topk_distance.cu`` keeps its product in float32; these tests fix
what an emulation with IEEE sums gives, for any later tensor-core design.

The launch plans (the kNN segment plan and the Cholesky cooperative grid)
take the SM count as an argument and are tested here without a card.
"""
import numpy as np
import pytest
import torch

from heat_tpu_torch.core.kernels import MAX_FUSED_N, chol_grid, knn_plan, knn_tiles

KNN_RTOL, KNN_ATOL, KNN_TIE_RTOL = 1e-4, 1e-5, 1e-5


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits' unit to the magnitude, mask."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def dot_3xtf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y.T as the kernel forms it: lo·hi + hi·lo, then + hi·hi."""
    xh, xl = split(x)
    yh, yl = split(y)
    return (xl @ yh.T + xh @ yl.T) + xh @ yh.T


def knn_from_dot(x, y, k, dot):
    """(d2, idx) of the k nearest rows with d2 = max((x2 + y2) - 2 dot, 0),
    ordered by (d, idx) as the kernel's lists are."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1)
    d = torch.clamp((x2 + y2.unsqueeze(0)) - 2.0 * dot, min=0.0)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), order.to(torch.int32)


def standardized_blobs(seed, n, f, k=8):
    """``chip_smoke.py``'s data recipe at a small size: k Gaussian blobs with
    centres 8 x N(0, 1), unit noise, standardized per column."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, f)) * 8.0
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, f))
    z = (x - x.mean(0)) / x.std(0)
    return torch.from_numpy(z.astype(np.float32))


def near_tie_violations(x, y, i, i0):
    """Entries whose index differs from the plain version's where the two
    rows' plain distances are not within KNN_TIE_RTOL of each other."""
    full = torch.clamp(torch.sum(x * x, 1, keepdim=True) + torch.sum(y * y, 1) - 2.0 * (x @ y.T), min=0.0)
    dk, dp = torch.gather(full, 1, i.long()), torch.gather(full, 1, i0.long())
    return int((((dk - dp).abs() > KNN_TIE_RTOL * (dp.abs() + 1.0)) & (i != i0)).sum())


def test_tf32_rounding_keeps_ten_mantissa_bits_and_rounds_away():
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32) * 100.0)
    r = tf32(v)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((r - v).abs() <= v.abs() * 2.0**-11).all())
    # exactly half an ulp of TF32 rounds away from zero, for both signs
    one_and_half_ulp = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert tf32(one_and_half_ulp).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
    hi, lo = split(v)
    assert bool(((hi + lo - v).abs() <= v.abs() * 2.0**-21).all())


@pytest.mark.parametrize("f", [1, 7, 32, 70])
def test_3xtf32_product_is_near_float32_and_1xtf32_is_not(f):
    rng = np.random.default_rng(f)
    x = rng.normal(size=(64, f)).astype(np.float32)
    y = rng.normal(size=(96, f)).astype(np.float32)
    exact = x.astype(np.float64) @ y.astype(np.float64).T
    scale = np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64).T
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    e3 = np.abs(dot_3xtf32(xt, yt).double().numpy() - exact) / scale
    e1 = np.abs((tf32(xt) @ tf32(yt).T).double().numpy() - exact) / scale
    # 3xTF32 drops only lo.lo (~2^-22 of each product) beside float32's own sum
    # roundings; one TF32 product is ~2^-11 off
    assert e3.max() <= 4 * f * 2.0**-24 + 2.0**-20
    assert e1.max() > 16 * e3.max()


@pytest.mark.parametrize("seed,n,m,f,k", [(0, 256, 16384, 32, 5), (1, 128, 8192, 32, 65), (2, 96, 5000, 7, 5), (3, 64, 3000, 70, 20)])
def test_3xtf32_neighbours_match_plain_outside_near_ties(seed, n, m, f, k):
    data = standardized_blobs(seed, n + m, f)
    x, y = data[:n], data[n:]
    d0, i0 = knn_tiles(x, y, k)
    d, i = knn_from_dot(x, y, k, dot_3xtf32(x, y))
    assert d.dtype == torch.float32 and tuple(i.shape) == (n, k)
    e = (d - d0).abs()
    assert bool((e <= KNN_ATOL + KNN_RTOL * d0.abs()).all()), float(e.max())
    assert near_tie_violations(x, y, i, i0) == 0


def test_1xtf32_neighbours_break_the_tolerance():
    # the reason for three products: one TF32 product moves the neighbours
    data = standardized_blobs(0, 256 + 16384, 32)
    x, y = data[:256], data[256:]
    _, i0 = knn_tiles(x, y, 5)
    _, i1 = knn_from_dot(x, y, 5, tf32(x) @ tf32(y).T)
    assert near_tie_violations(x, y, i1, i0) > 0


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize(
    "n,m,k,sms,per_sm",
    [(1 << 13, 1 << 22, 5, 132, 3), (8195, 100_003, 5, 132, 3), (37, 999, 7, 132, 3), (5, 64, 3, 132, 1),
     (50, 50, 50, 132, 3), (200, 3000, 1000, 132, 1), (1 << 20, 1 << 20, 5, 132, 3), (8195, 100_003, 1000, 114, 1)],
)
def test_knn_plan_covers_y_in_whole_tiles(n, m, k, sms, per_sm):
    nseg, seg_len = knn_plan(n, m, k, sms, per_sm)
    nqt = -(-n // 128)
    assert 1 <= nseg <= 64 and seg_len % 64 == 0
    assert nseg * seg_len >= m and (nseg - 1) * seg_len < m  # every segment has rows
    assert nseg == 1 or nqt * nseg <= sms * per_sm  # one wave of blocks
    assert nseg == 1 or nseg * n * k <= 1 << 28  # bounded (nseg, n, k) scratch


def test_knn_plan_at_the_knn_path_shape():
    # 64 query blocks x 6 segments = 384 blocks for 132 SMs x 3 blocks
    assert knn_plan(1 << 13, 1 << 22, 5, 132, 3) == (6, 699_072)


@pytest.mark.parametrize("n,want", [(1, 1), (32, 1), (33, 1), (129, 4), (300, 12), (1000, 128), (MAX_FUSED_N, 128)])
def test_chol_grid_is_co_resident_and_no_wider_than_the_work(n, want):
    assert chol_grid(n, 132, 2) == want
    assert chol_grid(n, 4, 1) == min(4, want)  # never more blocks than fit the card at once


def test_chol_grid_refuses_a_kernel_that_cannot_be_resident():
    with pytest.raises(RuntimeError, match="co-resident"):
        chol_grid(1024, 132, 0)
