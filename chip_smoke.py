#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check every kernel.

Run from the repository root, with no arguments, on a machine with an
NVIDIA Hopper card and the CUDA toolkit:

    python3 chip_smoke.py                  # every phase; [dist] on every visible card
    python3 chip_smoke.py --phases dist    # the build and [dist] only

Phases (any failure raises and exits non-zero; nothing is caught):

1. Environment: the card, its power limit, torch and CUDA versions.
2. Build: every ``heat_tpu_torch/core/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (in parallel), with ptxas' register / shared-memory report.
3. Each kernel against its plain PyTorch version on the card, at several
   shapes, main-path shapes included, with the tolerances below;
   ``lloyd_fused`` on both of its routes (``resident`` and ``general``),
   f up to 4097 and k * f past 8192; ``threefry_bits`` bit-identical to
   its plain version (bits, uniform float32 and float64, the main path's
   2^24 x 32 normal draw, and the permutation ``KMeans(init="random")``
   takes at n = 2^24).
4. Three paths at full width, each with its kernel launch counts zeroed
   just before and read just after, and held against the same path
   through the plain versions:
   - KMeans: 8 Gaussian blobs, n = 2^24 rows x f = 32 float32 (2 GiB;
     ``bench.py``'s k, f and iteration count at 32x its rows) drawn with
     ``ht.random.randn``, ``mean``/``std`` along axis 0, standardize,
     ``KMeans(8, init=8 rows of z, max_iter=30, tol=None).fit``,
     ``predict`` on 2^20 held-out rows;
   - kNN: ``KNeighborsClassifier(n_neighbors=5).fit`` on the first 2^22
     standardized rows (512 MiB) with the fit's labels, ``predict`` on 2^13
     held-out standardized rows; then ``spatial.nearest_neighbors`` at
     k = 100 (above the kernel's shared-memory lists) on the same data;
   - kernel ridge: ``K = rbf(X, X, sigma=sqrt(32)) + eye(1024)`` over the
     first 1024 standardized rows, ``L = cholesky(K)``, then
     ``alpha = solve_triangular(L.T, solve_triangular(L, y, lower=True))``;
   - the array surface on the KMeans path's standardized z (2^24 x 32):
     ``abs``, ``>``, ``any``, ``sum``, ``clip``, ``where``, ``min``/``max``/
     ``argmin``/``argmax`` along axis 0, ``exp``, ``log1p``, ``sqrt``,
     ``sin``, ``//``, ``%`` and ``cumsum``, held against numpy (exact, or
     within SURFACE_ULPS of the float64 value, or cumsum's rounding bound)
     on 2^16 rows, with no kernel launched;
   - the public ``linalg.cholesky`` of a matrix that is not positive
     definite, through the kernel: jnp's NaN pattern;
   - and a wide fit beside the paths: ``KMeans(16, max_iter=10,
     tol=None).fit`` on 16 blobs of n = 2^20 rows x f = 160, which takes
     ``lloyd_fused``'s general route, held against the plain fit;
   - tall-skinny ``linalg.qr`` + ``matmul`` (the ``BASELINE.json`` ladder's
     last rung): A = 2^24 x 64 float32, split=0; the route taken
     (``qr.cholqr2`` or ``qr.householder``), float64 residuals, R against
     ``torch.linalg.qr``'s, times against ``torch.linalg.qr`` and
     ``torch.matmul``.
5. Timing with CUDA events (median of single launches after warm-up; the
   repetitions are named per kernel): kernel, plain version, one-call
   library yardstick where one exists, and the bound of each kernel at its
   main-path shape (bytes over 3.35 TB/s or float32 flops over 67
   TFLOP/s). ``[design]`` lines name each redesigned kernel's launch plan.

6. ``[dist]``: the main path across every visible card, one process per
   card (spawned after the build, NCCL, no gloo fallback), 2^24 x 32 rows
   per card from one seed: ``mean``/``std`` -> standardize -> ``KMeans.fit``
   -> ``predict`` -> kNN ``predict`` (2^13 split-0 queries) -> ``qr`` +
   ``matmul(A.T, A)`` at 2^24 x 64 per card -> a resplit round trip ->
   the kernel-ridge path at 4096 rows per card (X of n x 32 drawn at
   split 0 and standardized, ``K = rbf(X, X)``, ``+ eye(n, split=0)``,
   ``cholesky(K, tiles_per_proc=4)``, whose 1024-wide diagonal blocks run
   ``chol_panel_fused`` on every rank above one card, and two
   ``solve_triangular``); per rank its launches, ``COLLECTIVES`` and
   times, the ridge residuals computed across ranks (L never gathered)
   and ``rbf(..., use_ring=True)`` against the default route; then the
   same paths in this process on the same global data as the reference
   (the ridge factor against the one-process factor of the same K), and
   the weak-scaling efficiency of the warm fit. ``--phases dist`` runs
   only phases 1, 2 and 6.

The line before last is one JSON object ``{"kernels": [...]}`` (not
printed with ``--phases dist``); the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---- tolerances, kernel vs plain version on the same inputs (float32) ------
# The kernel and its plain version add the same terms in different orders
# (per-block partials merged in a fixed tree on the card vs torch's own
# reductions), and the moments kernel sums in float64 where the plain
# version sums in float32. The bounds are float32 reassociation bounds, the
# ones heat_tpu's parity tests state for the same functions.
MEAN_RTOL, MEAN_ATOL = 2e-6, 2e-6   # mean: one rounding of s1 / n
M2_RTOL = 2e-4                      # M2: s2 - s1^2/n loses a few bits in float32
SUMS_RTOL = 1e-5                    # sums: relative to the largest |sum|
INERTIA_RTOL = 1e-4                 # inertia: one sum over all rows
TIE_RTOL = 1e-5                     # labels may differ only where the two smallest d2 are this close
CENTERS_RTOL = 1e-4                 # fitted centroids, kernel fit vs plain fit, relative to max |c|
# kNN: distances as heat_tpu's own kNN tests hold them. An index may differ
# from the plain version's only as far as float32 rounding of
# d2 = (|x|^2 + |y|^2) - 2 x.y lets two rows trade places. Both evaluate that
# formula, each in its own order; behind one d2 stand at most f + 2 roundings
# in a chain (one per product, f - 1 per sum of f terms, one for the add, one
# for the subtract), so (Higham, Accuracy and Stability of Numerical
# Algorithms, 2nd ed., sec. 3.1) each computed d2 is within
#   E(x, y) = gamma_{f+2} (|x|^2 + |y|^2 + 2 sum_i |x_i y_i|) <= gamma_{f+2} (|x| + |y|)^2
# of the exact one, gamma_n = n u / (1 - n u), u = 2^-24 (the clamp at 0 only
# moves d2 toward the exact value). If the kernel ranks row i_r r-th and the
# plain version row i0_r, then at least r + 1 rows (the plain list's first)
# have kernel values within 2 max E of the plain list's r-th value, so the
# exact distances obey
#   |D(i_r) - D(i0_r)| <= E(x, y_{i_r}) + E(x, y_{i0_r}) + 2 max_{j in either list} E(x, y_j).
# knn_check computes D in float64 and this bound per row from the norms.
KNN_RTOL, KNN_ATOL = 1e-4, 1e-5
F32_UNIT_ROUNDOFF = 2.0 ** -24
# Cholesky, kernel vs plain version: the same steps with float32 sums of up
# to n terms in another order (fmaf chains vs cuBLAS), relative to max |L|
CHOL_ATOL_REL = 2e-5
# kernel ridge: ||L L^T - K||max / ||K||max is float32 Cholesky's backward
# error, c n eps ~ 1e-4 at n = 1024 in the worst case; ||K a - y|| / ||y|| is
# that error times the condition of K (at most 1 + ||rbf|| ~ 1e3 here)
RIDGE_RECON_RTOL = 1e-4
RIDGE_SOLVE_RTOL = 1e-2
# qr, float64 residuals of the float32 factors: ||QR - A||max/||A||max and ||QᵀQ - I||max (what heat_tpu's
# qr tests hold), R against torch.linalg.qr's R after normalizing row signs, relative to max |R|; the
# float32 Gram AᵀA over 2^24 rows against the float64 one, relative to its largest entry (a sum's rounding
# grows like u sqrt(m) for random signs: 2^-24 * 2^12 = 2.4e-4)
QR_RESID_RTOL, QR_ORTHO_ATOL, QR_R_RTOL = 1e-5, 1e-4, 1e-4
QR_GRAM_RTOL = 1e-3
# threefry_bits' normal draw, kernel vs plain version: both round every product and sum on its own and call
# CUDA's log1pf and sqrtf, so equal bits are expected; held within 2 float32 ulp
THREEFRY_NORMAL_RTOL = 2 * 2.0 ** -23
# the surface's float functions against their float64 values, in float32 ulps: CUDA's expf and sinf are
# within 2 ulp, log1pf within 1, sqrtf and floor exact, and z % 1 one rounding of an exact value
SURFACE_ULPS = 2.0

# ---- the card's peaks (NVIDIA H100 SXM data sheet) --------------------------
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_MAIN, F_MAIN, K_MAIN, ITERS = 1 << 24, 32, 8, 30
N_PREDICT = 1 << 20
N_TRAIN, N_QUERY, KNN_K = 1 << 22, 1 << 13, 5  # kNN path
N_RIDGE = 1024                                 # kernel-ridge path: heat_tpu's MAX_FUSED_N
N_WIDE, F_WIDE, K_WIDE, ITERS_WIDE = 1 << 20, 160, 16, 10  # the wide fit: lloyd_fused's general route
N_QR, F_QR = 1 << 24, 64    # tall-skinny qr: bench.py's QR_F at 16x its QR_N rows (4 GiB float32)
QR_CHUNK = 1 << 22           # rows per float64 check chunk
# CholeskyQR2 as qr.py writes it reads or writes an (m, n) array 7 times: per pass the Gram (read), the
# triangular solve (read, write); then the guard's Gram of Q (read)
QR_CHOLQR2_PASSES = 7
N_SLICE, N_CUMSUM = 1 << 16, 4096  # the surface: rows compared with numpy, rows of the cumsum
THREEFRY_KEY = (0x2545F491, 0x6C078965)  # the phase-3 checks' key
# float32 operations per element of the normal draw: the uniform's subtract, multiply and add, u * u, log1p
# (counted as 10), a sqrt, a subtract, 9 multiply-adds of Horner's rule and two products; the ~70 32-bit
# integer operations of threefry's rounds have no peak in the table and are not counted
THREEFRY_NORMAL_FLOP = 36


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def knn_check(x, y, d, i, d0, i0):
    """Distances within KNN_RTOL/KNN_ATOL, and every index that differs from
    the plain version's within the rounding bound derived above; returns (max
    abs distance error, differing entries, largest |D(i_r) - D(i0_r)| / bound)."""
    import torch

    e = (d - d0).abs()
    check(bool((e <= KNN_ATOL + KNN_RTOL * d0.abs()).all()), f"kNN distances differ by up to {e.max().item()}")
    diff = i != i0
    rows = torch.nonzero(diff.any(dim=1)).flatten()
    nr = (x.shape[1] + 2) * F32_UNIT_ROUNDOFF
    gamma = nr / (1 - nr)
    worst = 0.0
    for r0 in range(0, rows.numel(), 256):
        rr = rows[r0 : r0 + 256]
        xr = x[rr].double().unsqueeze(1)                          # (R, 1, f)
        yk, yp = y[i[rr].long()].double(), y[i0[rr].long()].double()  # (R, k, f)
        gap = (((xr - yk) ** 2).sum(-1) - ((xr - yp) ** 2).sum(-1)).abs()  # exact distances, float64
        nx = xr.norm(dim=2)
        ek, ep = gamma * (nx + yk.norm(dim=2)) ** 2, gamma * (nx + yp.norm(dim=2)) ** 2
        bound = ek + ep + 2 * torch.maximum(ek.amax(1, keepdim=True), ep.amax(1, keepdim=True))
        check(bool((gap <= bound).all()), "kNN indices differ beyond float32 rounding of the distances")
        worst = max(worst, (gap / bound).max().item())
    return e.max().item(), int(diff.sum()), worst


def time_ms(fn, reps=25, warm=3):
    """The median of ``reps`` single calls after ``warm`` unmeasured ones,
    between CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # keep the card busy while the host enqueues: times the device, not the launch
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ulps(r, ref64):
    """|r - ref64| in units of the float32 spacing at ref64 (NaN where both
    are NaN; inf where only one is)."""
    import numpy as np

    r = r.astype(np.float64)
    both = np.isnan(r) & np.isnan(ref64)
    err = np.abs(r - ref64) / np.spacing(np.abs(ref64).astype(np.float32)).astype(np.float64)
    err[np.isnan(r) != np.isnan(ref64)] = np.inf
    return np.where(both, 0.0, err)


def spd(n, gen, dev):
    import torch

    g = torch.randn(n, n, device=dev, generator=gen, dtype=torch.float64)
    return (g @ g.T / n + torch.eye(n, device=dev, dtype=torch.float64)).to(torch.float32)


# ---- [dist]: the main path over torch.distributed, one process per card ------------------------
DIST_SEED, DIST_QR_SEED, DIST_RIDGE_SEED = 7, 8, 9
N_DIST_SLICE = 1 << 20  # rows of z in the resplit round trip
# the kernel-ridge path in [dist]: 4096 rows per card (n = 16384 at four cards: K is 1 GiB, 256 MiB per card);
# cholesky's tiles_per_proc = 4 makes its panels 4096 / 4 = 1024 = MAX_FUSED_N rows, so every diagonal block
# runs chol_panel_fused above one card (at one card n = 4096 > MAX_FUSED_N takes cholesky_ex)
N_RIDGE_CARD, RIDGE_TILES = 4096, 4


def _dist_data(ht, world):
    """The [dist] path's data, the same global arrays at any world size (the
    port's split draws are split-invariant): 8 Gaussian blobs of
    N_MAIN * world rows x F_MAIN, row i of the first K_MAIN in blob i, and
    N_QUERY held-out rows from the same blobs."""
    import torch

    n = N_MAIN * world
    ht.random.seed(DIST_SEED)
    true = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    member = ht.random.randint(0, K_MAIN, size=(n,), split=0, dtype=ht.int64)
    off = member.comm.chunk(member.gshape, 0)[0]
    if off < K_MAIN:
        member.larray[: K_MAIN - off] = torch.arange(off, K_MAIN, device=member.larray.device)
    x = ht.random.randn(n, F_MAIN, split=0) + ht.DNDarray(true.larray[member.larray], gshape=(n, F_MAIN), split=0)
    member_q = ht.random.randint(0, K_MAIN, size=(N_QUERY,), split=0, dtype=ht.int64)
    xq = ht.random.randn(N_QUERY, F_MAIN, split=0) + ht.DNDarray(
        true.larray[member_q.larray], gshape=(N_QUERY, F_MAIN), split=0)
    return true, member, x, member_q, xq


def _dist_qr_data(ht, world):
    ht.random.seed(DIST_QR_SEED)
    return ht.random.randn(N_QR * world, F_QR, split=0)


def _ceil_div_map(gshape, split, world):
    import numpy as np

    out = np.array([list(gshape)] * world, dtype=np.int64)
    n = gshape[split]
    block = -(-n // world)
    for r in range(world):
        start = min(r * block, n)
        out[r, split] = min(start + block, n) - start
    return out


def _dist_rank(rank, world, store, out_dir):
    """One rank of the [dist] phase: the main path on this rank's card over
    NCCL, its checks that need no single-process reference, and its times;
    what the parent compares goes to ``out_dir/rank{rank}.pt``."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import COLLECTIVES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ht.init_distributed(backend="nccl", init_method=f"file://{store}", world_size=world, rank=rank,
                        local_rank=rank, timeout=900)
    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    check(comm.size == world and comm.rank == rank and comm.backend == "nccl", f"group {comm}")
    check(ht.get_device() == ht.Device("gpu", rank) and torch.cuda.current_device() == rank, f"device {ht.get_device()}")

    def say(msg):
        print(f"[dist r{rank}] {msg}", flush=True)

    def sync():
        torch.cuda.synchronize()
        comm.barrier()

    def timed(fn):
        """(result, host s, CUDA-event ms) of one call, all ranks started
        together; ``timed.collectives`` holds what the call itself ran."""
        sync()
        before = {k: dict(v) for k, v in COLLECTIVES.items()}
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        timed.collectives = {
            k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v} for k, v in COLLECTIVES.items()
            if v["calls"] != before.get(k, {}).get("calls", 0)
        }
        return out, host, a.elapsed_time(b)

    say(f"{torch.cuda.get_device_name(rank)} cuda:{rank}, world size {comm.size}, backend {comm.backend}")
    true, member, x, member_q, xq = _dist_data(ht, world)
    want_map = _ceil_div_map(x.gshape, 0, world)
    check(np.array_equal(x.lshape_map, want_map) and tuple(x.larray.shape) == tuple(want_map[rank]),
          f"x lshape_map {x.lshape_map.tolist()}")
    say(f"x {x.gshape} split 0, lshape_map {x.lshape_map[:, 0].tolist()} rows; queries {xq.lshape_map[:, 0].tolist()}")
    torch.cuda.empty_cache()

    # ---- the path, counts zeroed just before and read just after
    sync()
    ht.kernels.reset_kernel_stats()
    t_path = time.perf_counter()
    (mu, sd), t_stats, ev_stats = timed(lambda: (ht.mean(x, axis=0), ht.std(x, axis=0)))
    z = (x - mu) / sd
    init = z[:K_MAIN].resplit(None)
    km, t_fit, ev_fit = timed(lambda: ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z))
    fit_coll = timed.collectives
    zq = (xq - mu) / sd
    pred = km.predict(zq)
    train, train_labels = z[:N_TRAIN], member[:N_TRAIN]
    clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels)
    knn_pred, t_knn, ev_knn = timed(lambda: clf.predict(zq))
    sync()
    path_s = time.perf_counter() - t_path
    launches, stats, colls = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS), {k: dict(v) for k, v in COLLECTIVES.items()}
    say(f"launches {launches} KERNEL_STATS {stats}")
    say(f"COLLECTIVES of the path {colls}")
    per_iter = {k: {f: v[f] / (ITERS + 1) for f in v} for k, v in fit_coll.items()}
    say(f"COLLECTIVES of the fit {fit_coll}: per Lloyd step (30 iterations + the inertia pass) {per_iter}")
    check(launches["moments_onepass"] == 1 and stats.get("moments_onepass.cuda") == 2,
          f"one moments launch per rank should serve mean and std: {launches}, {stats}")
    check(launches["lloyd_fused"] == ITERS + 1 and stats.get("lloyd_fused.resident") == ITERS + 1,
          f"lloyd launches per rank {launches['lloyd_fused']} != {ITERS + 1}, or not all resident: {stats}")
    check(launches["topk_distance"] == 1 and stats.get("topk_distance.cuda") == 1, f"topk launches {launches}, {stats}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the path: {stats}")
    packed = (K_MAIN * F_MAIN + K_MAIN + 1) * 4
    check(fit_coll == {"allreduce": {"calls": ITERS + 1, "bytes": (ITERS + 1) * packed}},
          f"the fit should run one allreduce of {packed} B per Lloyd step and nothing else: {fit_coll}")
    check(km.labels_.split == 0 and km.cluster_centers_.split is None and pred.split == 0 and knn_pred.split == 0,
          "result splits")
    check(np.array_equal(km.labels_.lshape_map, _ceil_div_map((N_MAIN * world,), 0, world)), "labels lshape_map")
    say(f"mean+std {t_stats:.4f} s host, {ev_stats:.4f} ms events; first fit {t_fit:.4f} s ({ITERS / t_fit:.1f} it/s); "
        f"kNN predict {t_knn:.4f} s host, {ev_knn:.4f} ms events; whole path {path_s:.3f} s")

    # ---- replicated results bit-identical on every rank
    def same_everywhere(t, name):
        parts = comm.allgather(t.contiguous().unsqueeze(0), 0, [1] * world)
        check(all(torch.equal(parts[r], parts[0]) for r in range(world)), f"{name} differs between ranks")

    for name, t in (("mean", mu.larray), ("std", sd.larray), ("centers", km.cluster_centers_.larray),
                    ("inertia", torch.tensor([km.inertia_], device=dev))):
        same_everywhere(t, name)
    acc = comm.allreduce((knn_pred.larray == member_q.larray).sum()).item() / N_QUERY
    check(acc > 0.999, f"kNN predict accuracy against the blobs {acc}")

    # ---- warm times
    _, t_warm, ev_warm = timed(lambda: ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z))
    _, t_knn_w, ev_knn_w = timed(lambda: clf.predict(zq))
    _, t_stats_w, ev_stats_w = timed(lambda: (ht.mean(x, axis=0), ht.std(x, axis=0)))
    d_nn, i_nn = ht.spatial.nearest_neighbors(zq, train, KNN_K)  # for the parent's index check; not on the path
    sl = z[:N_DIST_SLICE]
    rt, t_rs, ev_rs = timed(lambda: sl.resplit(1).resplit(None))
    check(rt.split is None and rt.gshape == sl.gshape, "resplit round trip metadata")
    off, lsh, _ = comm.chunk(sl.gshape, 0)
    check(torch.equal(rt.larray[off : off + lsh[0]], sl.larray), "resplit 0 -> 1 -> None changed the values")
    same_everywhere(rt.larray, "resplit round trip")
    say(f"warm fit {t_warm:.4f} s host ({ITERS / t_warm:.1f} it/s), {ev_warm:.4f} ms events; warm kNN predict "
        f"{t_knn_w:.4f} s, {ev_knn_w:.4f} ms events; warm mean+std {t_stats_w:.4f} s, {ev_stats_w:.4f} ms events; "
        f"resplit 0 -> 1 -> None of {sl.gshape} {t_rs:.4f} s, {ev_rs:.4f} ms events")
    result = {
        "rank": rank, "mu": mu.larray.cpu(), "sd": sd.larray.cpu(), "centers": km.cluster_centers_.larray.cpu(),
        "inertia": km.inertia_, "labels": km.labels_.larray.to(torch.int8).cpu(), "pred": pred.larray.cpu(),
        "knn_pred": knn_pred.larray.cpu(), "d_nn": d_nn.larray.cpu(), "i_nn": i_nn.larray.cpu(),
        "launches": launches, "stats": stats, "fit_collectives": fit_coll,
    }
    del x, z, zq, train, clf, rt, sl, d_nn, i_nn, km, member
    torch.cuda.empty_cache()

    # ---- tall-skinny qr + matmul: checks computed across ranks, Q never gathered
    A = _dist_qr_data(ht, world)
    torch.cuda.empty_cache()
    check(np.array_equal(A.lshape_map, _ceil_div_map(A.gshape, 0, world)), "A lshape_map")
    ht.kernels.reset_kernel_stats()
    (Q, R), t_qr, ev_qr = timed(lambda: ht.linalg.qr(A))
    qr_routes = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("qr.")}
    qr_coll = timed.collectives
    G, t_mm, ev_mm = timed(lambda: ht.matmul(A.T, A))
    check(Q.split == 0 and R.split is None and G.split is None and Q.gshape == A.gshape and R.gshape == (F_QR, F_QR),
          "qr / matmul metadata")
    a_l, q_l, r64 = A.larray, Q.larray, R.larray.double()
    resid, a_max = torch.zeros((), dtype=torch.float64, device=dev), torch.zeros((), dtype=torch.float64, device=dev)
    qtq, gram = torch.zeros(F_QR, F_QR, dtype=torch.float64, device=dev), torch.zeros_like(r64)
    for r0 in range(0, a_l.shape[0], QR_CHUNK):
        qc, ac = q_l[r0 : r0 + QR_CHUNK].double(), a_l[r0 : r0 + QR_CHUNK].double()
        resid = torch.maximum(resid, (qc @ r64 - ac).abs().max())
        a_max = torch.maximum(a_max, ac.abs().max())
        qtq += qc.T @ qc
        gram += ac.T @ ac
        del qc, ac
    resid = (comm.allreduce(resid, "max") / comm.allreduce(a_max, "max")).item()
    ortho = (comm.allreduce(qtq) - torch.eye(F_QR, dtype=torch.float64, device=dev)).abs().max().item()
    gram = comm.allreduce(gram)
    g_diff = (G.larray.double() - gram).abs().max().item() / gram.abs().max().item()
    check(resid <= QR_RESID_RTOL, f"distributed ||QR - A||max/||A||max = {resid}")
    check(ortho <= QR_ORTHO_ATOL, f"distributed ||QᵀQ - I||max = {ortho}")
    check(g_diff <= QR_GRAM_RTOL, f"matmul(A.T, A) vs float64 Gram: {g_diff}")
    same_everywhere(R.larray, "R")
    same_everywhere(G.larray, "A.T @ A")
    say(f"qr of {A.gshape} split 0 (lshape_map {A.lshape_map[:, 0].tolist()} rows): local route {qr_routes}, "
        f"COLLECTIVES {qr_coll}; {t_qr:.4f} s host, {ev_qr:.4f} ms events; ||QR - A||max/||A||max {resid:.3e}, "
        f"||QᵀQ - I||max {ortho:.3e}; matmul(A.T, A) {t_mm:.4f} s host, {ev_mm:.4f} ms events, vs float64 Gram "
        f"{g_diff:.3e}")
    _, t_qr_w, ev_qr_w = timed(lambda: ht.linalg.qr(A))
    _, t_mm_w, ev_mm_w = timed(lambda: ht.matmul(A.T, A))
    say(f"warm qr {t_qr_w:.4f} s host, {ev_qr_w:.4f} ms events; warm matmul(A.T, A) {t_mm_w:.4f} s, {ev_mm_w:.4f} ms")
    result.update(R=R.larray.cpu(), qr_resid=resid, qr_ortho=ortho, gram_diff=g_diff, qr_routes=qr_routes)
    del A, Q, R, G, a_l, q_l, r64, qtq, gram
    torch.cuda.empty_cache()
    result["ridge"] = _dist_ridge(ht, world, rank, timed, same_everywhere, say, out_dir)
    times = torch.tensor([t_stats, t_fit, t_warm, t_knn, t_knn_w, t_stats_w, t_qr, t_qr_w, t_mm, t_mm_w, t_rs, path_s],
                         dtype=torch.float64, device=dev)
    result["times_max"] = comm.allreduce(times, "max").cpu().tolist()
    result["events"] = [ev_stats, ev_fit, ev_warm, ev_knn, ev_knn_w, ev_stats_w, ev_qr, ev_qr_w, ev_mm, ev_mm_w, ev_rs]
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    comm.barrier()
    torch.distributed.destroy_process_group()


def _gamma(k):
    """Higham's gamma_k = k u / (1 - k u) for float32."""
    return k * F32_UNIT_ROUNDOFF / (1 - k * F32_UNIT_ROUNDOFF)


def _dist_ridge(ht, world, rank, timed, same_everywhere, say, out_dir):
    """The kernel-ridge path across the ranks at N_RIDGE_CARD rows per card, with its launch counts zeroed just
    before and read just after; the checks that need no one-process reference (computed across ranks, L never
    gathered); this rank's rows of K and L go to ``out_dir`` for the parent's factor check."""
    import torch

    from heat_tpu_torch.core.kernels import MAX_FUSED_N, cholesky_local

    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    n = N_RIDGE_CARD * world
    sigma = F_MAIN ** 0.5
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    ht.kernels.reset_kernel_stats()
    ht.random.seed(DIST_RIDGE_SEED)
    X, yv = step("draw X, y", lambda: (ht.random.randn(n, F_MAIN, split=0), ht.random.randn(n, split=0)))
    mu, sd = step("mean+std", lambda: (ht.mean(X, axis=0), ht.std(X, axis=0)))
    Xs = (X - mu) / sd
    K0 = step("rbf", lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma))
    K = step("+ eye", lambda: K0 + ht.eye(n, split=0))
    L = step("cholesky", lambda: ht.linalg.cholesky(K, tiles_per_proc=RIDGE_TILES))
    z1 = step("solve L", lambda: ht.linalg.solve_triangular(L, yv, lower=True))
    alpha = step("solve L.T", lambda: ht.linalg.solve_triangular(L.T, z1, lower=False))
    launches, stats = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS)
    bs = ht.factor_block_edge(K, RIDGE_TILES, -(-n // world))
    panels = -(-n // bs)
    say(f"ridge n={n} ({N_RIDGE_CARD} rows per card), cholesky panels of {bs} rows: launches {launches} "
        f"KERNEL_STATS {stats}")
    say("ridge per call: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES "
                                       f"{v['collectives']}" for k, v in steps.items()))
    check(launches["threefry_bits"] == 2 and stats.get("threefry_bits.cuda") == 2, f"ridge draws {launches}")
    if world > 1:
        check(bs == MAX_FUSED_N and launches["chol_panel_fused"] == panels
              and stats.get("chol_panel_fused.cuda") == panels,
              f"every rank should factor each of the {panels} diagonal blocks with chol_panel_fused: {launches}, {stats}")
    else:
        check(stats.get("chol_panel_fused.fallback") == 1 and launches["chol_panel_fused"] == 0,
              f"one card: n = {n} > MAX_FUSED_N takes cholesky_ex: {stats}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the ridge path: {stats}")
    check(K.split == 0 and L.split == 0 and alpha.split == (0 if world > 1 else None) and L.gshape == (n, n),
          "ridge splits / shapes")

    # ||L L^T - K|| across ranks: L's row chunks rotate around the ring, block (r, q) = L_r L_q^T in float64.
    # Higham (2nd ed.) Thm 10.3: the computed factor of a symmetric positive definite K satisfies
    # L L^T = K + dK with |dK| <= gamma_{n+1} |L| |L^T|, and (|L| |L^T|)_ij <= |L_i| |L_j| = sqrt(K_ii K_jj)
    # (+ O(u)), at most max K_ii = ||K||max here (rbf <= 1 off the diagonal, 2 on it): the blocked schedule
    # computes the same inner products in another order, so ||dK||max / ||K||max <= gamma_{n+1}.
    counts = [int(c) for c in L.lshape_map[:, 0]]
    starts = [sum(counts[:q]) for q in range(world)]
    Lr, Kr = L.larray, K.larray
    check(bool(torch.isfinite(Lr).all()) and bool((torch.triu(Lr, diagonal=starts[rank] + 1) == 0).all()),
          "ridge L finite and lower")
    buf = torch.zeros((max(counts), n), dtype=Lr.dtype, device=dev)
    buf[: counts[rank]] = Lr
    dk_max, dk_f2 = torch.zeros((), dtype=torch.float64, device=dev), torch.zeros((), dtype=torch.float64, device=dev)
    for s_ in range(world):
        q = (rank + s_) % world
        if counts[q] and counts[rank]:
            d = Lr.double() @ buf[: counts[q]].double().T - Kr[:, starts[q] : starts[q] + counts[q]].double()
            dk_max = torch.maximum(dk_max, d.abs().max())
            dk_f2 += (d * d).sum()
            del d
        if s_ < world - 1:
            buf = comm.ring_shift(buf)
    del buf
    k_max = comm.allreduce(Kr.abs().max().double(), "max").item()
    k_inf = comm.allreduce(Kr.double().abs().sum(1).max(), "max").item()  # ||K||_inf >= ||K||_2
    recon = comm.allreduce(dk_max, "max").item() / k_max
    dk_fro = comm.allreduce(dk_f2).sqrt().item()
    check(recon <= _gamma(n + 1), f"ridge ||L L^T - K||max/||K||max = {recon} > gamma_(n+1) = {_gamma(n + 1)}")
    # ||K a - y|| / ||y||: K a - y = -dK' a with dK' the factorization's and the solves' backward errors, and
    # ||K^-1|| <= 1 (K = rbf + I, rbf positive semi-definite): the relative residual is at most ||dK'||_2
    a_full = alpha._logical().double()
    r2 = comm.allreduce(((Kr.double() @ a_full - yv.larray.double()) ** 2).sum())
    y2 = comm.allreduce((yv.larray.double() ** 2).sum())
    resid = (r2 / y2).sqrt().item()
    check(resid <= RIDGE_SOLVE_RTOL, f"ridge ||K alpha - y||/||y|| = {resid}")

    # rbf on the ring against the default route: each d2 = (|x|^2 + |y|^2) - 2 x.y is within
    # E = gamma_{f+2} (|x| + |y|)^2 of the exact one (see knn_check), so the two routes' d2 differ by at most
    # 2 E <= 2 gamma_{f+2} (2 max|x|)^2; exp(-d2 / (2 sigma^2)) moves by at most its argument's change (d2 >= 0)
    # and rounds once on each side
    K_ring, t_ring, ev_ring = timed(lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma, use_ring=True))
    ring_coll = timed.collectives
    ring_diff = comm.allreduce((K_ring.larray - K0.larray).abs().max() if counts[rank] else
                               torch.zeros((), device=dev), "max").item()
    x_max = comm.allreduce(Xs.larray.norm(dim=1).max() if counts[rank] else torch.zeros((), device=dev), "max").item()
    ring_bound = 2 * _gamma(F_MAIN + 2) * (2 * x_max) ** 2 / (2 * sigma**2) + 2 * F32_UNIT_ROUNDOFF
    check(ring_diff <= ring_bound, f"rbf use_ring vs the default route: {ring_diff} > {ring_bound}")
    if world > 1:
        check(ring_coll.get("ring_shift", {}).get("calls") == world - 1 and "allgather" not in ring_coll,
              f"the ring route should shift y's chunks {world - 1} times and gather nothing: {ring_coll}")
    del K_ring

    # replicated state bit-identical on every rank: the standardization, and a diagonal block's factor from the
    # same broadcast slab (what every rank computes once per panel inside cholesky)
    same_everywhere(mu.larray, "ridge mean")
    same_everywhere(sd.larray, "ridge std")
    b = min(MAX_FUSED_N, counts[0])
    blk = Kr[:b, :b].contiguous() if rank == 0 else torch.empty((b, b), dtype=Kr.dtype, device=dev)
    same_everywhere(cholesky_local(comm.bcast(blk, 0)), "a diagonal block's chol_panel_fused factor")
    # the same calls again, warm (every first call above carries cuBLAS' and cuSOLVER's set-up for its shapes)
    warm = {}
    for name, fn in (("rbf", lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma)), ("+ eye", lambda: K0 + ht.eye(n, split=0)),
                     ("cholesky", lambda: ht.linalg.cholesky(K, tiles_per_proc=RIDGE_TILES)),
                     ("solve L", lambda: ht.linalg.solve_triangular(L, yv, lower=True)),
                     ("solve L.T", lambda: ht.linalg.solve_triangular(L.T, z1, lower=False))):
        _, host, ev = timed(fn)
        warm[name] = {"host_s": host, "event_ms": ev}
    say("ridge warm per call: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events"
                                            for k, v in warm.items()))
    say(f"ridge ||L L^T - K||max/||K||max {recon:.3e} (gamma_(n+1) {_gamma(n + 1):.3e}), ||L L^T - K||_F "
        f"{dk_fro:.3e}; ||K alpha - y||/||y|| {resid:.3e}; rbf use_ring vs default max abs {ring_diff:.3e} (bound "
        f"{ring_bound:.3e}), ring rbf {t_ring:.4f} s host, {ev_ring:.4f} ms events, COLLECTIVES {ring_coll}")
    torch.save({"K": Kr.cpu(), "L": Lr.cpu()}, os.path.join(out_dir, f"ridge{rank}.pt"))
    return {"steps": steps, "warm": warm, "launches": launches, "stats": stats, "recon": recon, "dk_fro": dk_fro, "k_inf": k_inf,
            "resid": resid, "ring_diff": ring_diff, "ring_bound": ring_bound, "ring_host_s": t_ring,
            "ring_event_ms": ev_ring, "ring_collectives": ring_coll, "counts": counts, "bs": bs}


def _ridge_reference(ht, world, ranks, tmp):
    """The one-process factor of the ranks' K on this card, against the ranks' L: their difference within a
    bound derived from both factors' measured backward errors."""
    import torch

    dev = ht.get_device().torch_device
    n = N_RIDGE_CARD * world
    parts = [torch.load(os.path.join(tmp, f"ridge{r}.pt")) for r in range(world)]
    K = torch.cat([p["K"] for p in parts]).to(dev)
    Ls = [p["L"] for p in parts]
    del parts
    t_one = []
    for _ in range(2):  # the first call, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L0 = ht.linalg.cholesky(ht.array(K, copy=False)).larray
        torch.cuda.synchronize()
        t_one.append(time.perf_counter() - t0)
    L064 = L0.double()
    dk2_f2 = 0.0
    for r0 in range(0, n, 2048):
        d = L064[r0 : r0 + 2048] @ L064.T - K[r0 : r0 + 2048].double()
        dk2_f2 += (d * d).sum().item()
        del d
    dk2 = dk2_f2**0.5
    diff_f2, diff_max, r0 = 0.0, 0.0, 0
    for Lr in Ls:
        d = Lr.to(dev).double() - L064[r0 : r0 + Lr.shape[0]]
        diff_f2 += (d * d).sum().item()
        diff_max = max(diff_max, d.abs().max().item()) if d.numel() else diff_max
        r0 += Lr.shape[0]
        del d
    diff = diff_f2**0.5
    # Both factors are exact for K + dK_i (||dK_i||_F measured: dk1 across ranks, dk2 here). With
    # E = L0^-1 (dK_1 - dK_2) L0^-T, ||E||_F <= ||(K + dK_2)^-1||_2 ||dK_1 - dK_2||_F <= (dk1 + dk2) / (1 - dk2)
    # (lambda_min(K) >= 1), and L_1 = L0 chol(I + E), so to first order
    # ||L_1 - L0||_F <= ||L0||_2 ||E||_F / sqrt(2) with ||L0||_2^2 = ||K + dK_2||_2 <= ||K||_inf + dk2; a factor 2
    # covers the higher-order terms while ||E|| is small
    dk1, k_inf = ranks[0]["ridge"]["dk_fro"], ranks[0]["ridge"]["k_inf"]
    bound = 2 * (k_inf + dk2) ** 0.5 * (dk1 + dk2) / (2**0.5 * (1 - dk2))
    check(dk2 < 0.5 and diff <= bound, f"[dist] ridge L vs the one-process factor: ||dL||_F {diff} > bound {bound}")
    del K, L0, L064, Ls
    torch.cuda.empty_cache()
    return {"diff_fro": diff, "diff_max": diff_max, "bound": bound, "dk2": dk2, "t_one": t_one}


def dist_phase(world: int) -> None:
    """[dist]: the main path at world size ``world`` (one process per card,
    NCCL; weak scaling: N_MAIN rows per card), then the single-process port
    on the same global data in this process, and the comparison."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import heat_tpu_torch as ht
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        print(f"[dist] spawning {world} rank(s) over NCCL, {N_MAIN} x {F_MAIN} rows per card", flush=True)
        t0 = time.perf_counter()
        mp.start_processes(_dist_rank, args=(world, os.path.join(tmp, "store"), tmp), nprocs=world, join=True,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
        print(f"[dist] {world} rank(s) done in {time.perf_counter() - t0:.1f} s (spawn and start included)", flush=True)

        # the single-process port on the same global data, the ranks' standardization applied
        ht.use_device("gpu")
        dev = ht.get_device().torch_device
        true, member, x, member_q, xq = _dist_data(ht, world)
        mu0, sd0 = ht.mean(x, axis=0).larray, ht.std(x, axis=0).larray
        mu, sd = ranks[0]["mu"].to(dev), ranks[0]["sd"].to(dev)
        check(bool(((mu - mu0).abs() <= MEAN_ATOL + MEAN_RTOL * mu0.abs()).all()), "[dist] mean vs one process")
        check(bool(((sd - sd0).abs() <= M2_RTOL * sd0.abs()).all()), "[dist] std vs one process")
        z = (x - ht.array(mu)) / ht.array(sd)
        del x
        km0 = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
        c0 = km0.cluster_centers_.larray
        c = ranks[0]["centers"].to(dev)
        cdiff = (c - c0).abs().max().item()
        check(cdiff <= CENTERS_RTOL * c0.abs().max().item(), f"[dist] centroids vs one process: {cdiff}")
        check(abs(ranks[0]["inertia"] - km0.inertia_) <= INERTIA_RTOL * abs(km0.inertia_), "[dist] inertia")
        labels = torch.cat([r["labels"] for r in ranks]).to(dev).long()
        ldiff = labels != km0.labels_.larray
        near_rows = 0
        if bool(ldiff.any()):
            rows = torch.nonzero(ldiff).flatten()
            two = torch.topk(_quadratic_expand(z.larray[rows], c0), 2, dim=1, largest=False).values
            near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
            check(bool(near.all()), "[dist] labels differ from one process outside near-ties")
            near_rows = int(near.sum())
        zq = (xq - ht.array(mu)) / ht.array(sd)
        pred0 = km0.predict(zq).larray
        pdiff = int((torch.cat([r["pred"] for r in ranks]).to(dev) != pred0).sum())
        train, train_labels = z[:N_TRAIN], member[:N_TRAIN]
        d0, i0 = ht.spatial.nearest_neighbors(zq, train, KNN_K)
        d, i = torch.cat([r["d_nn"] for r in ranks]).to(dev), torch.cat([r["i_nn"] for r in ranks]).to(dev)
        e_d, nd, worst = knn_check(zq.larray, train.larray, d, i, d0.larray, i0.larray)
        knn0 = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels).predict(zq).larray
        knn = torch.cat([r["knn_pred"] for r in ranks]).to(dev)
        kdiff = knn != knn0
        check(not bool((kdiff & ~(i != i0.larray).any(dim=1)).any()),
              "[dist] kNN labels differ from one process where the neighbours are the same")
        # one card's share, timed on one card: the weak-scaling baseline
        z1 = z[:N_MAIN]
        init1 = z1[:K_MAIN]
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ht.cluster.KMeans(n_clusters=K_MAIN, init=init1, max_iter=ITERS, tol=None).fit(z1)
            torch.cuda.synchronize()
            t1 = time.perf_counter() - t1
        del z, z1, zq, train, km0, xq, member
        torch.cuda.empty_cache()
        A = _dist_qr_data(ht, world)
        r0 = ht.linalg.qr(A, calc_q=False).R.larray
        del A
        torch.cuda.empty_cache()

        def sign_normalized(r):
            s_ = torch.sign(torch.diagonal(r))
            return r * torch.where(s_ == 0, torch.ones_like(s_), s_)[:, None]

        r_diff = (sign_normalized(ranks[0]["R"].to(dev)) - sign_normalized(r0)).abs().max().item() / r0.abs().max().item()
        check(r_diff <= QR_R_RTOL, f"[dist] R vs one process's R: {r_diff}")
        ref = _ridge_reference(ht, world, ranks, tmp)
        rg = ranks[0]["ridge"]
        print(f"[dist] ridge n={N_RIDGE_CARD * world}: chol_panel_fused launches per rank "
              f"{[r['ridge']['launches']['chol_panel_fused'] for r in ranks]} (panels of {rg['bs']} rows), routes "
              f"{[{k: v for k, v in r['ridge']['stats'].items() if k.startswith('chol_panel_fused')} for r in ranks]}; "
              f"||L L^T - K||max/||K||max {rg['recon']:.3e}, ||K alpha - y||/||y|| {rg['resid']:.3e}; rbf use_ring vs "
              f"default {rg['ring_diff']:.3e} (bound {rg['ring_bound']:.3e}); L vs the one-process factor of the same "
              f"K: ||dL||_F {ref['diff_fro']:.3e} (bound {ref['bound']:.3e}), max abs {ref['diff_max']:.3e}; "
              f"one-process cholesky of K on one card {ref['t_one'][0]:.4f} s host first call, {ref['t_one'][1]:.4f} s "
              f"warm", flush=True)
        for r in ranks:
            print(f"[dist] ridge r{r['rank']}: " + "; ".join(
                f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES {v['collectives']}"
                for k, v in r["ridge"]["steps"].items()) + f"; ring rbf {r['ridge']['ring_host_s']:.4f} s host, "
                f"{r['ridge']['ring_event_ms']:.4f} ms events, COLLECTIVES {r['ridge']['ring_collectives']}; warm: "
                + ", ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events"
                            for k, v in r["ridge"]["warm"].items()), flush=True)
        tm = ranks[0]["times_max"]
        print(f"[dist] world size {world}; per rank: launches {[r['launches'] for r in ranks]}; fit COLLECTIVES "
              f"{ranks[0]['fit_collectives']}; qr local routes {[r['qr_routes'] for r in ranks]}", flush=True)
        print(f"[dist] vs one process on the same {N_MAIN * world} x {F_MAIN} data: mean/std within their bounds; "
              f"centroids max abs {cdiff:.3e}; labels differ on {int(ldiff.sum())} rows ({near_rows} near-tie); "
              f"predict differs on {pdiff} of {N_QUERY}; kNN distances max abs {e_d:.3e}, indices differ on {nd} "
              f"entries (largest gap {worst:.3f} of the bound), labels on {int(kdiff.sum())}; R {r_diff:.3e} of max |R|; "
              f"||QR - A||/||A|| {ranks[0]['qr_resid']:.3e}, ||QᵀQ - I|| {ranks[0]['qr_ortho']:.3e}", flush=True)
        names = ["mean+std", "first fit", "warm fit", "kNN predict", "warm kNN predict", "warm mean+std", "qr",
                 "warm qr", "matmul(A.T, A)", "warm matmul", "resplit 0->1->None", "whole path"]
        print("[dist] slowest rank's host times (s): " + ", ".join(f"{n} {t:.4f}" for n, t in zip(names, tm)), flush=True)
        print("[dist] CUDA-event ms per rank: " + "; ".join(
            f"r{r['rank']}: " + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, r["events"])) for r in ranks), flush=True)
        print(f"[dist] warm fit: {world} card(s) x {N_MAIN} rows {tm[2]:.4f} s ({ITERS / tm[2]:.1f} it/s); one card, "
              f"{N_MAIN} rows, one process {t1:.4f} s; weak-scaling efficiency t(1 card) / t({world} cards) "
              f"{t1 / tm[2]:.3f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive heat_tpu_torch's main path on the cards and check every kernel.")
    ap.add_argument("--phases", choices=("all", "dist"), default="all",
                    help="all (default): every phase; dist: environment, build and [dist] only")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import _build

    check(os.path.dirname(os.path.abspath(ht.__file__)) == os.path.join(ROOT, "heat_tpu_torch"),
          f"heat_tpu_torch imported from {ht.__file__}, not from this checkout")
    # the plain versions' matrix products run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 1. environment
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] device={kind} count={torch.cuda.device_count()} nvidia-smi=({smi}) torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}", flush=True)
    print(smi, flush=True)

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)", flush=True)
    for name, info in sorted(built.items()):
        print(f"[build] {name}: {info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
        for line in info.ptxas:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {line}")
    check(set(built) >= {"moments", "lloyd", "topk_distance", "panel_update", "threefry"}, f"built {sorted(built)}")

    kernels = single_card_phases(dev) if args.phases == "all" else None
    torch.cuda.empty_cache()
    dist_phase(torch.cuda.device_count())
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def single_card_phases(dev) -> list:
    """Phases 3 to 5 on one card; returns the kernels' rows of the JSON line."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import (
        assign_stats, chol_block_size, chol_panels, cholesky_local, chunk_moments, forced_mode, knn_tiles,
        lloyd_local, lloyd_route, moments_local, nearest_neighbors_local, resident_smem,
    )
    from heat_tpu_torch.core import random as ht_random
    from heat_tpu_torch.core.kernels import lloyd, panel_update, threefry_bits, threefry_plain, topk_distance
    from heat_tpu_torch.core.kernels.threefry import chunk_layout
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the checks of lloyd_fused's routes past the resident one draw from their own stream, so
    # every path's data is what it was before they were added
    gen_routes = torch.Generator(device=dev)
    gen_routes.manual_seed(1)
    # the C1 and qr phases draw from a third stream, for the same reason
    gen_new = torch.Generator(device=dev)
    gen_new.manual_seed(2)
    errors = {}

    # ----------------------------------------------- 3. kernels vs plain versions
    for n, f, nv in [(N_MAIN, F_MAIN, N_MAIN), (1_000_003, 18, 999_000), (4099, 1, 4099), (1, 5, 1)]:
        x = torch.randn(n, f, device=dev, generator=gen) * 3.0 + 5.0
        cnt, mean, m2 = moments_local(x, nv)
        cnt0, mean0, m20 = chunk_moments(x, nv)
        torch.cuda.synchronize()
        check(float(cnt) == float(cnt0) == float(nv), f"moments counts {float(cnt)} vs {float(cnt0)} vs {nv}")
        e_mean = (mean - mean0).abs()
        e_m2 = (m2 - m20).abs()
        check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"moments mean at {(n, f, nv)}")
        check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"moments M2 at {(n, f, nv)}")
        rel_m2 = (e_m2 / m20.abs().clamp(min=1e-30)).max().item()
        print(f"[check] moments_onepass n={n} f={f} n_valid={nv}: count exact, mean max abs {e_mean.max().item():.3e} "
              f"(max rel {(e_mean / mean0.abs().clamp(min=1e-30)).max().item():.3e}), M2 max abs {e_m2.max().item():.3e} "
              f"(max rel {rel_m2:.3e})", flush=True)
        if n == N_MAIN:
            errors["moments_onepass"] = max(e_mean.max().item(), e_m2.max().item())
        del x
    lloyd_shapes = [(s, gen) for s in [(N_MAIN, F_MAIN, K_MAIN, N_MAIN), (1_000_003, 18, 5, 999_000),
                                       (65_536, 64, 64, 65_536), (7, 3, 2, 7)]]
    # past the resident route: f > 128 (the wide fit's shape among them), and k * f > 8192 on both routes
    lloyd_shapes += [(s, gen_routes) for s in [(100_003, 129, 3, 100_000), (65_536, F_WIDE, K_WIDE, 65_000),
                                               (20_000, 1000, 5, 19_000), (5_000, 4097, 3, 4_900),
                                               (65_536, 64, 160, 65_536), (30_000, 64, 400, 29_000)]]
    for (n, f, k, nv), g in lloyd_shapes:
        cen = torch.randn(k, f, device=dev, generator=g) * 8.0
        truth = torch.randint(0, k, (n,), device=dev, generator=g)
        x = cen[truth] + torch.randn(n, f, device=dev, generator=g)
        route = lloyd_route(f, k)
        routed = ht.KERNEL_STATS.get(f"lloyd_fused.{route}", 0)
        sums, counts, labels, inertia = lloyd_local(x, cen, nv)
        check(ht.KERNEL_STATS.get(f"lloyd_fused.{route}") == routed + 1, f"lloyd route {route} not counted at {(n, f, k)}")
        sums0, counts0, labels0, inertia0 = assign_stats(x, cen, nv)
        torch.cuda.synchronize()
        check(bool((counts == counts0).all()), f"lloyd counts at {(n, f, k, nv)}")
        d2 = _quadratic_expand(x[:nv], cen)
        two = torch.topk(d2, min(2, k), dim=1, largest=False).values
        near = (two[:, -1] - two[:, 0]) <= TIE_RTOL * two[:, -1]
        diff = labels[:nv] != labels0[:nv]
        check(not bool((diff & ~near).any()), f"lloyd labels differ outside near-ties at {(n, f, k, nv)}")
        e_sums = (sums - sums0).abs().max().item()
        check(e_sums <= SUMS_RTOL * sums0.abs().max().item(), f"lloyd sums at {(n, f, k, nv)}: {e_sums}")
        e_in = abs(float(inertia) - float(inertia0))
        check(e_in <= INERTIA_RTOL * abs(float(inertia0)), f"lloyd inertia at {(n, f, k, nv)}")
        again = lloyd_local(x, cen, nv)
        check(all(bool((a == b).all()) for a, b in zip(again, (sums, counts, labels, inertia))),
              f"lloyd not bit-identical from run to run at {(n, f, k, nv)}")
        print(f"[check] lloyd_fused ({route}) n={n} f={f} k={k} n_valid={nv}: counts exact, labels differ on {int(diff.sum())} rows "
              f"({int(near.sum())} near-tie rows), sums max abs {e_sums:.3e} (max |sum| {sums0.abs().max().item():.3e}), "
              f"inertia rel {e_in / max(abs(float(inertia0)), 1e-30):.3e}, bit-identical rerun", flush=True)
        if n == N_MAIN:
            errors["lloyd_fused"] = max(e_sums, e_in)
        del x, d2
    lsms = lloyd._sm_count(0)
    lper_sm = lloyd._blocks_per_sm(0, F_MAIN, K_MAIN, True)
    lgrid = lloyd.lloyd_resident_plan(N_MAIN, lsms, lper_sm)
    print(f"[design] lloyd_fused: resident route at n={N_MAIN} f={F_MAIN} k={K_MAIN}: 2 CUDA kernels per call (partial, "
          f"reduce); one-wave grid {lgrid} blocks x {lloyd._TILE} threads ({lper_sm} blocks/SM x {lsms} SMs), each a "
          f"contiguous run of {lloyd._TILE}-row tiles; {lloyd._STAGES} cp.async stages (16-byte copies, rows padded to "
          f"f + 4 floats), {lloyd._STAGES - 1} tiles in flight per block = "
          f"{lper_sm * (lloyd._STAGES - 1) * lloyd._TILE * F_MAIN * 4} B per SM; {resident_smem(F_MAIN, K_MAIN)} B of "
          f"shared memory per block. General route (3 CUDA kernels: assign, scatter, reduce) where f > {lloyd._TILE} "
          f"or the resident block passes 227 KB", flush=True)
    knn_shapes = [(N_QUERY, N_TRAIN, F_MAIN, KNN_K), (1000, 3000, 7, 1), (37, 999, 16, 7), (128, 64, 32, 64),
                  # lists in scratch above MAX_K, and k = m
                  (1000, 20_000, 32, 65), (1000, 20_000, 32, 200), (300, 5000, 7, 1000), (70, 333, 70, 333)]
    # n and m off the 128-row query block and the 64-row y tile, on both copy variants and over one chunk
    knn_shapes += [(N_QUERY + 3, 100_003, f, KNN_K) for f in (1, 7, 32, 70)]
    for n, m, f, k in knn_shapes:
        x = torch.randn(n, f, device=dev, generator=gen)
        y = torch.randn(m, f, device=dev, generator=gen)
        d, i = nearest_neighbors_local(x, y, k)
        d0, i0 = knn_tiles(x, y, k)
        torch.cuda.synchronize()
        check(tuple(i.shape) == (n, k) and i.dtype == torch.int32 and bool(((i >= 0) & (i < m)).all()), "kNN indices")
        e_d, ndiff, worst = knn_check(x, y, d, i, d0, i0)
        again = nearest_neighbors_local(x, y, k)
        check(torch.equal(again[0], d) and torch.equal(again[1], i), f"kNN not bit-identical from run to run at {(n, m, f, k)}")
        print(f"[check] topk_distance n={n} m={m} f={f} k={k}: distances max abs {e_d:.3e}, indices differ on {ndiff} "
              f"entries, all within the rounding bound (largest gap {worst:.3f} of it), bit-identical rerun", flush=True)
        if n == N_QUERY and m == N_TRAIN:
            errors["topk_distance"] = e_d
        del x, y, d, i, d0, i0, again
    sms, knn_per_sm = topk_distance._occupancy(0, F_MAIN, KNN_K)
    nseg, seg_len = topk_distance.knn_plan(N_QUERY, N_TRAIN, KNN_K, sms, knn_per_sm)
    print(f"[design] topk_distance: product route fp32 (CUDA cores; 4 query rows x 16 y rows per thread), 3 CUDA kernels per call "
          f"(row norms, partial, merge); at n={N_QUERY} m={N_TRAIN} f={F_MAIN} k={KNN_K}: "
          f"{-(-N_QUERY // topk_distance._ROWS)} query blocks of {topk_distance._ROWS} rows x {nseg} y-segments of "
          f"{seg_len} rows = {-(-N_QUERY // topk_distance._ROWS) * nseg} blocks ({knn_per_sm} blocks/SM x {sms} SMs); "
          f"y tiles of {topk_distance._YT} rows x 32 columns through 3 cp.async stages (16-byte copies when f % 4 == 0); "
          f"per-row lists in shared memory for k <= {topk_distance.MAX_K}, in the scratch above", flush=True)
    for n in (N_RIDGE, 1000, 129, 33, 32, 31, 1):
        a = spd(n, gen, dev)
        L = cholesky_local(a)
        L0 = chol_panels(a, chol_block_size(n))
        torch.cuda.synchronize()
        e_l = (L - L0).abs().max().item()
        check(e_l <= CHOL_ATOL_REL * L0.abs().max().item(), f"chol vs plain at n={n}: {e_l}")
        check(bool((torch.triu(L, 1) == 0).all()), f"chol upper triangle not zero at n={n}")
        check(torch.equal(cholesky_local(a), L), f"chol not bit-identical from run to run at n={n}")
        recon = (L.double() @ L.double().T - a.double()).abs().max().item() / a.abs().max().item()
        print(f"[check] chol_panel_fused n={n}: vs plain max abs {e_l:.3e} (max |L| {L0.abs().max().item():.3e}), "
              f"||L L^T - A||max/||A||max {recon:.3e}, upper zero, bit-identical rerun", flush=True)
        if n == N_RIDGE:
            errors["chol_panel_fused"] = e_l
    for jf in (700, 704):  # 704 sits on a 32-wide panel's edge
        a = spd(N_RIDGE, gen, dev)
        a[jf, jf] = -50.0  # not positive definite from pivot jf on: NaN, never an error
        L, L0 = cholesky_local(a), chol_panels(a, chol_block_size(N_RIDGE))
        check(torch.equal(torch.isnan(L), torch.isnan(L0)) and bool(torch.isnan(L[jf:, jf]).all())
              and bool(torch.isfinite(L[:, :jf]).all()), f"chol NaN pattern of a non-SPD matrix vs plain (pivot {jf})")
        print(f"[check] chol_panel_fused non-SPD n={N_RIDGE}: NaN mask equal to the plain version's "
              f"({int(torch.isnan(L).sum())} NaN entries, columns >= {jf})", flush=True)
        del a, L, L0
    sms, chol_per_sm = panel_update._occupancy(0)
    print(f"[design] chol_panel_fused: 1 CUDA kernel per call (one cudaLaunchCooperativeKernel), "
          f"cooperative grid {panel_update.chol_grid(N_RIDGE, sms, chol_per_sm)} blocks x {panel_update._THREADS} threads "
          f"at n={N_RIDGE} ({chol_per_sm} blocks/SM x {sms} SMs co-resident), panels of {panel_update._PANEL} columns, "
          f"{-(-N_RIDGE // panel_update._PANEL) + 1} grid barriers (look-ahead: one per panel)", flush=True)
    # threefry_bits, the port's own kernel: every kind bit-identical to its plain version, at the main path's
    # draw (2^24 x 32 normal float32) and beside it; a chunk of a split-1 draw (rows of indices, strided)
    lo32 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    lo64 = float(np.nextafter(-1.0, 0.0))
    main_draw = (chunk_layout((N_MAIN, F_MAIN), None, 0, 0), "normal32", lo32, 2.0)
    for layout, kind, lo, scale in [main_draw, (chunk_layout((N_MAIN, F_MAIN), None, 0, 0), "uniform32", 0.0, 1.0),
                                    (chunk_layout((1 << 26,), None, 0, 0), "uniform64", 0.0, 1.0),
                                    (chunk_layout((1 << 24,), None, 0, 0), "normal64", lo64, 2.0),
                                    (chunk_layout((N_MAIN,), None, 0, 0), "bits32", 0.0, 1.0),
                                    (chunk_layout((1 << 24,), None, 0, 0), "bits64", 0.0, 1.0),
                                    (chunk_layout((4096, 4099), 1, 1025, 1025), "uniform32", 0.0, 1.0)]:
        got = threefry_bits(THREEFRY_KEY, layout, kind, dev, lo, scale)
        want = threefry_plain(THREEFRY_KEY, layout, kind, dev, lo, scale)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        if kind.startswith("normal"):
            e_tf = (got - want).abs().max().item()
            check(bool(((got - want).abs() <= THREEFRY_NORMAL_RTOL * want.abs()).all()),
                  f"threefry_bits {kind} vs plain beyond 2 ulp: max abs {e_tf}")
            if layout == main_draw[0] and kind == main_draw[1]:
                errors["threefry_bits"] = e_tf
        else:
            check(same, f"threefry_bits {kind} at layout {layout} differs from its plain version")
        print(f"[check] threefry_bits {kind} layout (base, row_stride, rows, cols) {layout}: "
              f"{'bit-identical to the plain version' if same else f'max abs {e_tf:.3e} from the plain version'}",
              flush=True)
        del got, want
    # the permutation KMeans(init="random") takes at n = 2^24: three rounds of 32-bit keys and a stable sort
    perm_key = ht_random._fold_in(ht_random._prng_key(0), 0)
    reset_launches = ht.LAUNCHES["threefry_bits"]
    perm = ht_random._shuffle(perm_key, N_MAIN, dev)
    perm_launches = ht.LAUNCHES["threefry_bits"] - reset_launches
    with forced_mode("threefry_bits", "torch"):
        perm0 = ht_random._shuffle(perm_key, N_MAIN, dev)
    torch.cuda.synchronize()
    check(torch.equal(perm, perm0), "the n = 2^24 permutation differs between threefry_bits and its plain version")
    check(torch.equal(torch.sort(perm).values, torch.arange(N_MAIN, device=dev)), "the permutation is no permutation")
    first_keys = threefry_bits(ht_random._split(perm_key)[1], chunk_layout((N_MAIN,), None, 0, 0), "bits32", dev)
    ties = N_MAIN - torch.unique(first_keys).numel()
    print(f"[check] threefry_bits permutation of arange(2^24) ({perm_launches} kernel launches, one per round): "
          f"identical to the plain version's; {ties} colliding 32-bit keys in the first round, ordered by the "
          f"stable sort", flush=True)
    del perm, perm0, first_keys
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 4. main path
    ht.use_device("gpu")
    member = torch.randint(0, K_MAIN, (N_MAIN + N_PREDICT,), device=dev, generator=gen)
    member[:K_MAIN] = torch.arange(K_MAIN, device=dev)  # rows 0..7: one of each blob, the init rows
    torch.cuda.synchronize()

    # the path starts with its draws: three through threefry_bits (the centres, x, the held-out rows)
    ht.kernels.reset_kernel_stats()
    t_draw = time.perf_counter()
    ht.random.seed(0)
    true_centers = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    x = ht.random.randn(N_MAIN, F_MAIN, split=0) + ht.array(true_centers.larray[member[:N_MAIN]], split=0, copy=False)
    x_new = ht.random.randn(N_PREDICT, F_MAIN, split=0) + ht.array(true_centers.larray[member[N_MAIN:]], split=0, copy=False)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t_draw
    t_main = time.perf_counter()
    mu = ht.mean(x, axis=0)
    sd = ht.std(x, axis=0)
    moments_after_stats = ht.LAUNCHES["moments_onepass"]
    z = (x - mu) / sd
    t_fit = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    pred = km.predict((x_new - mu) / sd)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(ht.LAUNCHES)
    stats = dict(ht.KERNEL_STATS)
    print(f"[main] launches {launches} KERNEL_STATS {stats}", flush=True)
    print(f"[main] draws {draw_s:.3f} s (first calls); mean+std+standardize+fit+predict {main_s:.3f} s; fit "
          f"{fit_s:.3f} s ({ITERS / fit_s:.1f} iterations/s) at n={N_MAIN} f={F_MAIN} k={K_MAIN}", flush=True)
    check(launches["threefry_bits"] == 3 and stats.get("threefry_bits.cuda") == 3,
          f"the path's three draws should each launch threefry_bits once: {launches}, {stats}")
    check(moments_after_stats == 1 and launches["moments_onepass"] == 1,
          f"one moments launch should serve mean and std, got {moments_after_stats}")
    check(stats.get("moments_onepass.cuda") == 2, f"moments dispatches {stats}")
    check(launches["lloyd_fused"] == ITERS + 1, f"lloyd launches {launches['lloyd_fused']} != max_iter + 1")
    check(stats.get("lloyd_fused.cuda") == 1 and not any(k.endswith(".torch") for k in stats), f"dispatch {stats}")
    check(stats.get("lloyd_fused.resident") == ITERS + 1 and "lloyd_fused.general" not in stats,
          f"the main path's Lloyd launches should all take the resident route: {stats}")

    centers = km.cluster_centers_.larray
    check(tuple(centers.shape) == (K_MAIN, F_MAIN) and bool(torch.isfinite(centers).all()), "centers shape/finite")
    check(km.n_iter_ == ITERS and km.labels_.shape == (N_MAIN,) and km.labels_.split == 0, "fit metadata")
    check(km.labels_.larray.dtype == torch.int64 and pred.shape == (N_PREDICT,), "label dtype / predict shape")
    check(mu.shape == (F_MAIN,) and mu.split is None and z.split == 0, "moments shape / split")
    # the fit recovers the standardized blob centres (init row j lies in blob j)
    want = (true_centers.larray - mu.larray) / sd.larray
    rec = (centers - want).abs().max().item()
    check(rec < 1e-2, f"fitted centers are {rec} from the standardized blob centres")
    acc = (pred.larray == member[N_MAIN:]).float().mean().item()
    check(acc > 0.999, f"predict accuracy on held-out rows {acc}")
    print(f"[main] centers within {rec:.3e} of the standardized blob centres; held-out predict accuracy {acc:.6f}; "
          f"inertia {km.inertia_:.6e}", flush=True)

    # the same path through the plain versions, from the same init
    with forced_mode("moments_onepass", "torch"), forced_mode("lloyd_fused", "torch"):
        mu0 = ht.mean(x, axis=0)
        sd0 = ht.std(x, axis=0)
        t0 = time.perf_counter()
        km0 = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
        torch.cuda.synchronize()
        fit_plain_s = time.perf_counter() - t0
    check(bool(((mu.larray - mu0.larray).abs() <= MEAN_ATOL + MEAN_RTOL * mu0.larray.abs()).all()), "main-path mean vs plain")
    check(bool(((sd.larray - sd0.larray).abs() <= M2_RTOL * sd0.larray.abs()).all()), "main-path std vs plain")
    lab, lab0 = km.labels_.larray, km0.labels_.larray
    d2 = _quadratic_expand(z.larray, km0.cluster_centers_.larray)  # near-ties judged against the plain fit's centres
    two = torch.topk(d2, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    ldiff = lab != lab0
    check(not bool((ldiff & ~near).any()), "main-path labels differ from the plain fit outside near-ties")
    cdiff = (centers - km0.cluster_centers_.larray).abs().max().item()
    check(cdiff <= CENTERS_RTOL * km0.cluster_centers_.larray.abs().max().item(), f"centroids vs plain fit: {cdiff}")
    check(abs(km.inertia_ - km0.inertia_) <= INERTIA_RTOL * abs(km0.inertia_), "inertia vs plain fit")
    print(f"[main] vs plain fit: labels differ on {int(ldiff.sum())} rows ({int(near.sum())} near-tie rows), "
          f"centroids max abs {cdiff:.3e}, inertia {km.inertia_:.6e} vs {km0.inertia_:.6e}; plain fit {fit_plain_s:.3f} s",
          flush=True)
    zq = ((x_new - mu) / sd)[:N_QUERY]
    member_q = member[N_MAIN : N_MAIN + N_QUERY]
    del d2, two, near, ldiff, lab0, km0, mu0, sd0, x_new, pred
    torch.cuda.empty_cache()

    # the kNN path: label new points by the fit's clusters
    train, train_labels = z[:N_TRAIN], km.labels_[:N_TRAIN]
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels)
    knn_pred = clf.predict(zq)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    launches["topk_distance"] = ht.LAUNCHES["topk_distance"]
    stats = dict(ht.KERNEL_STATS)
    print(f"[knn] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; fit+predict {knn_s:.3f} s "
          f"({N_QUERY} queries x {N_TRAIN} training rows x f={F_MAIN}, k={KNN_K})", flush=True)
    check(stats.get("topk_distance.cuda") == 1 and "topk_distance.torch" not in stats
          and "topk_distance.fallback" not in stats, f"kNN dispatch {stats}")
    check(launches["topk_distance"] == 1, f"topk_distance launches {launches['topk_distance']}")
    check(knn_pred.shape == (N_QUERY,) and knn_pred.split == 0 and knn_pred.larray.dtype == torch.int64, "kNN predict meta")
    knn_acc = (knn_pred.larray == member_q).float().mean().item()
    check(knn_acc > 0.999, f"kNN predict accuracy against the blobs {knn_acc}")
    with forced_mode("topk_distance", "torch"):
        t0 = time.perf_counter()
        knn_pred0 = clf.predict(zq)
        torch.cuda.synchronize()
        knn_plain_s = time.perf_counter() - t0
        dq0, iq0 = ht.spatial.nearest_neighbors(zq, train, KNN_K)
    dq, iq = ht.spatial.nearest_neighbors(zq, train, KNN_K)
    e_q, nd_q, worst_q = knn_check(zq.larray, train.larray, dq.larray, iq.larray, dq0.larray, iq0.larray)
    pdiff = knn_pred.larray != knn_pred0.larray
    check(not bool((pdiff & ~(iq.larray != iq0.larray).any(dim=1)).any()),
          "kNN labels differ from the plain predict where the neighbours are the same")
    print(f"[knn] accuracy against the blobs {knn_acc:.6f}; vs plain predict ({knn_plain_s:.3f} s): labels differ on "
          f"{int(pdiff.sum())} rows, neighbour indices on {nd_q} entries (all within the rounding bound, largest gap "
          f"{worst_q:.3f} of it), distances max abs {e_q:.3e}",
          flush=True)
    del dq, iq, dq0, iq0, knn_pred0
    # k above the kernel's shared-memory lists: heat_tpu answers any k <= m, and so does the port on a card
    dq, iq = ht.spatial.nearest_neighbors(zq, train, 100)
    dq0, iq0 = knn_tiles(zq.larray, train.larray, 100)
    check(tuple(iq.shape) == (N_QUERY, 100) and iq.larray.dtype == torch.int32, f"nearest_neighbors k=100 {tuple(iq.shape)}")
    e_100, nd_100, worst_100 = knn_check(zq.larray, train.larray, dq.larray, iq.larray, dq0, iq0)
    print(f"[knn] spatial.nearest_neighbors k=100 on the kNN path's data vs knn_tiles: distances max abs "
          f"{e_100:.3e}, indices differ on {nd_100} entries, all within the rounding bound (largest gap "
          f"{worst_100:.3f} of it)", flush=True)
    del dq, iq, dq0, iq0

    # the kernel-ridge path: Cholesky of an RBF Gram matrix, two triangular solves
    X = z[:N_RIDGE]
    yv = ht.array(torch.randn(N_RIDGE, device=dev, generator=gen), split=0)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    K = ht.spatial.rbf(X, X, sigma=F_MAIN ** 0.5) + 1.0 * ht.eye(N_RIDGE)
    L = ht.linalg.cholesky(K)
    alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, yv, lower=True), lower=False)
    torch.cuda.synchronize()
    ridge_s = time.perf_counter() - t0
    launches["chol_panel_fused"] = ht.LAUNCHES["chol_panel_fused"]
    stats = dict(ht.KERNEL_STATS)
    print(f"[ridge] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; rbf+eye+cholesky+2 solves {ridge_s:.4f} s "
          f"at n={N_RIDGE}", flush=True)
    check(stats.get("chol_panel_fused.cuda") == 1 and launches["chol_panel_fused"] == 1, f"ridge dispatch {stats}")
    Kt, Lt, at = K.larray, L.larray, alpha.larray
    check(L.shape == (N_RIDGE, N_RIDGE) and L.split == K.split and alpha.shape == (N_RIDGE,), "ridge shapes / split")
    check(bool(torch.isfinite(Lt).all()) and bool((torch.triu(Lt, 1) == 0).all()), "ridge L finite and lower")
    recon = (Lt.double() @ Lt.double().T - Kt.double()).abs().max().item() / Kt.abs().max().item()
    resid = (torch.linalg.norm(Kt.double() @ at.double() - yv.larray.double()) / torch.linalg.norm(yv.larray.double())).item()
    check(recon <= RIDGE_RECON_RTOL, f"||L L^T - K||max/||K||max = {recon}")
    check(resid <= RIDGE_SOLVE_RTOL, f"||K alpha - y||/||y|| = {resid}")
    with forced_mode("chol_panel_fused", "torch"):
        L0 = ht.linalg.cholesky(K).larray
    e_L = (Lt - L0).abs().max().item()
    check(e_L <= CHOL_ATOL_REL * L0.abs().max().item(), f"ridge L vs plain L: {e_L}")
    check(torch.equal(ht.linalg.cholesky(K).larray, Lt), "ridge L not bit-identical from run to run")
    print(f"[ridge] ||L L^T - K||max/||K||max {recon:.3e}; ||K alpha - y||/||y|| {resid:.3e}; L vs plain L max abs "
          f"{e_L:.3e}; L bit-identical on rerun", flush=True)

    # the surface: elementwise, relational and extrema functions on the KMeans path's standardized z, as a
    # user writes them; none of them launches a kernel of the port
    z_host = z.larray.cpu().numpy()
    s0 = N_MAIN // 2
    zs32 = z_host[s0 : s0 + N_SLICE]
    zs = zs32.astype(np.float64)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    mask = ht.abs(z) > 3
    surface = {
        "mask": mask, "any": ht.any(mask, axis=1), "sum": ht.sum(mask), "clip": ht.clip(z, -3, 3),
        "where": ht.where(mask, 0.0, z), "min": ht.min(z, axis=0), "max": ht.max(z, axis=0),
        "argmin": ht.argmin(z, axis=0), "argmax": ht.argmax(z, axis=0), "exp": ht.exp(z),
        "log1p_abs": ht.log1p(ht.abs(z)), "sqrt": ht.sqrt(z), "sin": ht.sin(z), "floordiv": z // 1, "mod": z % 1,
        "cumsum": ht.cumsum(z[:N_CUMSUM], axis=0),
    }
    torch.cuda.synchronize()
    surface_s = time.perf_counter() - t0
    check(not any(ht.LAUNCHES.values()), f"the surface launched a kernel of the port: {dict(ht.LAUNCHES)}")
    for name, r in surface.items():
        check(r.larray.is_cuda and r.device.device_type == "gpu", f"surface {name} is not on the card")
    host = {k: v.larray[s0 : s0 + N_SLICE].cpu().numpy() for k, v in surface.items()
            if k not in ("sum", "min", "max", "argmin", "argmax", "cumsum")}  # the compared rows
    big = np.abs(zs32) > 3
    exact = {  # bool, int and index results, and the exact float ones, against numpy
        "mask": (host["mask"], big),
        "any": (host["any"], big.any(axis=1)),
        "sum": (surface["sum"].numpy(), np.count_nonzero(np.abs(z_host) > 3)),
        "clip": (host["clip"], np.clip(zs32, -3, 3)),
        "where": (host["where"], np.where(big, np.float32(0), zs32)),
        "min": (surface["min"].numpy(), z_host.min(axis=0)), "max": (surface["max"].numpy(), z_host.max(axis=0)),
        "argmin": (surface["argmin"].numpy(), z_host.argmin(axis=0)),
        "argmax": (surface["argmax"].numpy(), z_host.argmax(axis=0)),
    }
    for name, (got, want) in exact.items():
        check(np.array_equal(got, want), f"surface {name} differs from numpy")
    check(surface["argmin"].larray.dtype == torch.int64 and surface["sum"].larray.dtype == torch.int64, "surface int64 results")
    with np.errstate(invalid="ignore"):
        refs = {"exp": np.exp(zs), "log1p_abs": np.log1p(np.abs(zs)), "sqrt": np.sqrt(zs), "sin": np.sin(zs),
                "floordiv": np.floor(zs), "mod": zs - np.floor(zs)}
    max_ulps = {}
    for name, ref in refs.items():
        max_ulps[name] = float(ulps(host[name], ref).max())
        check(max_ulps[name] <= SURFACE_ULPS, f"surface {name} is {max_ulps[name]} ulp from the float64 value")
    # a prefix of k float32 terms summed in any order is within gamma_k sum|z_i| of the exact prefix (Higham 4.2)
    zc = z_host[:N_CUMSUM].astype(np.float64)
    k = np.arange(1, N_CUMSUM + 1, dtype=np.float64)[:, None] * F32_UNIT_ROUNDOFF
    c_gap = np.abs(surface["cumsum"].numpy() - np.cumsum(zc, axis=0))
    c_bound = k / (1 - k) * np.cumsum(np.abs(zc), axis=0)
    check(bool((c_gap <= c_bound).all()), "surface cumsum beyond gamma_k sum|z|")
    print(f"[surface] {len(surface) + 1} calls on z ({N_MAIN} x {F_MAIN}) in {surface_s:.4f} s (host clock, first calls); "
          f"all results on {surface['exp'].larray.device}; kernel launches {dict(ht.LAUNCHES)}; |z| > 3 in "
          f"{int(exact['sum'][1])} entries; mask/any/sum/clip/where/min/max/argmin/argmax "
          f"equal to numpy; max ulp vs float64 on rows {s0}..{s0 + N_SLICE - 1}: "
          + ", ".join(f"{k_} {v:.2f}" for k_, v in max_ulps.items())
          + f"; cumsum of {N_CUMSUM} rows at most {(c_gap / c_bound).max():.4f} of its rounding bound", flush=True)
    del surface, host, mask, z_host, exact

    # C1 on the card: the public Cholesky of a matrix that is not positive definite gives jnp's NaN pattern
    # (NaN on and below the diagonal, zeros above) through the kernel
    a_bad = spd(N_RIDGE, gen_new, dev)
    a_bad[700, 700] = -50.0
    ht.kernels.reset_kernel_stats()
    L_bad = ht.linalg.cholesky(ht.array(a_bad, split=0)).larray
    torch.cuda.synchronize()
    check(ht.KERNEL_STATS.get("chol_panel_fused.cuda") == 1 and ht.LAUNCHES["chol_panel_fused"] == 1,
          f"non-SPD cholesky dispatch {dict(ht.KERNEL_STATS)}")
    lower = torch.ones_like(L_bad, dtype=torch.bool).tril()
    check(torch.equal(torch.isnan(L_bad), lower) and bool((L_bad[~lower] == 0).all()),
          "public cholesky of a non-SPD matrix: not NaN on and below the diagonal with zeros above")
    print(f"[c1] linalg.cholesky of spd({N_RIDGE}) with a[700, 700] = -50 on the chol_panel_fused.cuda route: "
          f"{int(torch.isnan(L_bad).sum())} NaN entries = the whole lower triangle, zeros above", flush=True)
    del a_bad, L_bad, lower

    # the wide fit: f = 160 takes lloyd_fused's general route, as heat_tpu's kernel takes any f
    wide_true = torch.randn(K_WIDE, F_WIDE, device=dev, generator=gen_routes) * 8.0
    wide_member = torch.randint(0, K_WIDE, (N_WIDE,), device=dev, generator=gen_routes)
    wide_member[:K_WIDE] = torch.arange(K_WIDE, device=dev)
    xw = ht.array(wide_true[wide_member] + torch.randn(N_WIDE, F_WIDE, device=dev, generator=gen_routes), split=0)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    kw = ht.cluster.KMeans(n_clusters=K_WIDE, init=xw[:K_WIDE], max_iter=ITERS_WIDE, tol=None).fit(xw)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    stats = dict(ht.KERNEL_STATS)
    print(f"[wide] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; fit {wide_s:.3f} s at n={N_WIDE} f={F_WIDE} "
          f"k={K_WIDE}, {ITERS_WIDE} iterations", flush=True)
    check(stats.get("lloyd_fused.general") == ITERS_WIDE + 1 and "lloyd_fused.resident" not in stats
          and ht.LAUNCHES["lloyd_fused"] == ITERS_WIDE + 1, f"the wide fit should take the general route: {stats}")
    cw = kw.cluster_centers_.larray
    check(tuple(cw.shape) == (K_WIDE, F_WIDE) and bool(torch.isfinite(cw).all()), "wide fit centers shape/finite")
    with forced_mode("lloyd_fused", "torch"):
        t0 = time.perf_counter()
        kw0 = ht.cluster.KMeans(n_clusters=K_WIDE, init=xw[:K_WIDE], max_iter=ITERS_WIDE, tol=None).fit(xw)
        torch.cuda.synchronize()
        wide_plain_s = time.perf_counter() - t0
    cw0 = kw0.cluster_centers_.larray
    e_cw = (cw - cw0).abs().max().item()
    check(e_cw <= CENTERS_RTOL * cw0.abs().max().item(), f"wide fit centroids vs plain fit: {e_cw}")
    d2 = _quadratic_expand(xw.larray, cw0)
    two = torch.topk(d2, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    wdiff = kw.labels_.larray != kw0.labels_.larray
    check(not bool((wdiff & ~near).any()), "wide fit labels differ from the plain fit outside near-ties")
    check(abs(kw.inertia_ - kw0.inertia_) <= INERTIA_RTOL * abs(kw0.inertia_), "wide fit inertia vs plain fit")
    rec_w = (cw - wide_true).abs().max().item()
    check(rec_w < 5e-2, f"wide fit centers are {rec_w} from the blob centres")
    print(f"[wide] vs plain fit ({wide_plain_s:.3f} s): labels differ on {int(wdiff.sum())} rows ({int(near.sum())} "
          f"near-tie rows), centroids max abs {e_cw:.3e}, inertia {kw.inertia_:.6e} vs {kw0.inertia_:.6e}; centers "
          f"within {rec_w:.3e} of the blob centres", flush=True)
    del d2, two, near, wdiff, kw0

    # --------------------------------------------------------------- 5. timing
    xa, za = x.larray, z.larray
    c0 = km.cluster_centers_.larray
    rows = {}
    rows["moments_onepass"] = {
        "ms": time_ms(lambda: moments_local(xa)),
        "plain_ms": time_ms(lambda: chunk_moments(xa, xa.shape[0])),
        "library_ms": time_ms(lambda: torch.var_mean(xa, dim=0, correction=0)),
        # read x once, write count + mean + M2; per element a subtract, an add and a multiply-add
        "bytes": xa.numel() * 4 + (2 * F_MAIN + 1) * 4,
        "ops": 4 * xa.numel(),
        "source": "heat_tpu_torch/core/kernels/csrc/moments.cu",
        "replaces": "heat_tpu/core/kernels/moments.py:90",
    }
    rows["lloyd_fused"] = {
        "ms": time_ms(lambda: lloyd_local(za, c0)),
        "plain_ms": time_ms(lambda: assign_stats(za, c0)),
        "library_ms": None,  # no single PyTorch call computes labels + per-cluster sums + counts + inertia
        # read x and the centers, write labels, sums, counts, inertia; 2 n k f for the distances, n f for the sums
        "bytes": za.numel() * 4 + c0.numel() * 4 + N_MAIN * 4 + (K_MAIN * F_MAIN + K_MAIN + 1) * 4,
        "ops": 2 * N_MAIN * K_MAIN * F_MAIN + N_MAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/lloyd.cu",
        "replaces": "heat_tpu/core/kernels/lloyd.py:52",
    }
    xwa = xw.larray
    gen_ms, gen_plain_ms = time_ms(lambda: lloyd_local(xwa, cw), reps=10, warm=2), time_ms(lambda: assign_stats(xwa, cw), reps=10, warm=2)
    print(f"[time] lloyd_fused general route at n={N_WIDE} f={F_WIDE} k={K_WIDE}: kernel_ms {gen_ms:.4f} plain_ms "
          f"{gen_plain_ms:.4f} bytes bound_ms {(xwa.numel() + N_WIDE) * 4 / HBM_BYTES_PER_S * 1e3:.4f} (context only; "
          f"the JSON row is the main path's shape)", flush=True)
    del xw, xwa
    ta, tq = train.larray, zq.larray
    rows["topk_distance"] = {
        # 5 launches of a kernel near 0.1 s; the plain version takes seconds: 2 after 1 warm-up
        "ms": time_ms(lambda: nearest_neighbors_local(tq, ta, KNN_K), reps=5, warm=1),
        "plain_ms": time_ms(lambda: knn_tiles(tq, ta, KNN_K), reps=2, warm=1),
        "library_ms": None,  # no single PyTorch call computes a top-k of distances without the matrix
        # read x and y once, write d and idx; 2 n m f flops for the distances
        "bytes": (N_QUERY + N_TRAIN) * F_MAIN * 4 + N_QUERY * KNN_K * 8,
        "ops": 2 * N_QUERY * N_TRAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/topk_distance.cu",
        "replaces": "heat_tpu/core/kernels/topk_distance.py:65",
    }

    def materialized_topk():
        # the (n, m) matrix is 128 GiB at this shape: 16 slices of 512 query rows
        for r0 in range(0, N_QUERY, 512):
            torch.topk(_quadratic_expand(tq[r0 : r0 + 512], ta), KNN_K, dim=1, largest=False)

    mat_ms = time_ms(materialized_topk, reps=2, warm=1)
    print(f"[time] materializing _quadratic_expand + topk over the kNN path's shape (16 slices of 512 query rows): "
          f"{mat_ms:.4f} ms (context only; not a library_ms)", flush=True)
    rows["chol_panel_fused"] = {
        "ms": time_ms(lambda: cholesky_local(Kt)),
        "plain_ms": time_ms(lambda: chol_panels(Kt, chol_block_size(N_RIDGE)), reps=5, warm=1),
        "library_ms": time_ms(lambda: torch.linalg.cholesky(Kt)),
        # read A once, write L once; n^3 / 3 flops
        "bytes": 2 * N_RIDGE * N_RIDGE * 4,
        "ops": N_RIDGE ** 3 / 3,
        "source": "heat_tpu_torch/core/kernels/csrc/panel_update.cu",
        "replaces": "heat_tpu/core/kernels/panel_update.py:95",
    }
    tf_layout, tf_kind, tf_lo, tf_scale = main_draw
    rows["threefry_bits"] = {
        "ms": time_ms(lambda: threefry_bits(THREEFRY_KEY, tf_layout, tf_kind, dev, tf_lo, tf_scale)),
        "plain_ms": time_ms(lambda: threefry_plain(THREEFRY_KEY, tf_layout, tf_kind, dev, tf_lo, tf_scale), reps=3,
                            warm=1),
        "library_ms": None,  # no PyTorch call draws threefry's bits (torch.randn draws Philox's: context only)
        # nothing read, the (n, f) float32 draw written once; float32 operations per element as counted above
        "bytes": N_MAIN * F_MAIN * 4,
        "ops": THREEFRY_NORMAL_FLOP * N_MAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/threefry.cu",
        "replaces": "none: jax.random threefry-2x32 in heat_tpu/core/random.py:79 (XLA-fused, not a Pallas kernel)",
    }
    randn_ms = time_ms(lambda: torch.randn(N_MAIN, F_MAIN, device=dev, generator=gen))
    print(f"[time] torch.randn({N_MAIN}, {F_MAIN}) on its Philox generator: {randn_ms:.4f} ms (context only; "
          f"another function, not a library_ms)", flush=True)
    t0 = time.perf_counter()
    ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    print(f"[time] warm fit {warm_fit_s:.4f} s ({ITERS / warm_fit_s:.1f} iterations/s, {ITERS + 1} lloyd launches)", flush=True)

    kernels = []
    for name in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused", "threefry_bits"):
        r = rows[name]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": errors[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
        })
        print(f"[time] {name}: kernel_ms {r['ms']:.4f} bound_ms {bound:.4f} ({kernels[-1]['bound_by']}; "
              f"{r['bytes']} B, {r['ops']} flop) share {bound / r['ms']:.3f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"launches per main path {launches[name]}", flush=True)

    # the ladder's last rung: tall-skinny qr + matmul on split=0 data (after the kernels' timing, so that
    # they are timed as in earlier runs)
    a_t = torch.randn(N_QR, F_QR, device=dev, generator=gen_new)
    A = ht.array(a_t, split=0, copy=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    Q, R = ht.linalg.qr(A)
    torch.cuda.synchronize()
    qr_s = time.perf_counter() - t0
    qr_peak = torch.cuda.max_memory_allocated()
    routes = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("qr.")}
    check(sum(routes.values()) == 1 and not any(ht.LAUNCHES.values()), f"qr routes {routes}, launches {dict(ht.LAUNCHES)}")
    qr_route = next(iter(routes))
    check(Q.shape == (N_QR, F_QR) and Q.split == 0 and R.shape == (F_QR, F_QR) and R.split is None
          and Q.larray.dtype == R.larray.dtype == torch.float32 and Q.larray.is_cuda and R.larray.is_cuda, "qr metadata")
    a_max = a_t.abs().max().item()
    r64 = R.larray.double()
    resid, qtq, gram = 0.0, torch.zeros(F_QR, F_QR, dtype=torch.float64, device=dev), torch.zeros_like(r64)
    for r0 in range(0, N_QR, QR_CHUNK):  # float64 checks, a chunk of rows at a time
        qc, ac = Q.larray[r0 : r0 + QR_CHUNK].double(), a_t[r0 : r0 + QR_CHUNK].double()
        resid = max(resid, (qc @ r64 - ac).abs().max().item())
        qtq += qc.T @ qc
        gram += ac.T @ ac
        del qc, ac
    resid /= a_max
    ortho = (qtq - torch.eye(F_QR, dtype=torch.float64, device=dev)).abs().max().item()
    check(resid <= QR_RESID_RTOL, f"||QR - A||max/||A||max = {resid}")
    check(ortho <= QR_ORTHO_ATOL, f"||QᵀQ - I||max = {ortho}")
    del Q
    r_lib = torch.linalg.qr(a_t, mode="r").R

    def sign_normalized(r):
        s_ = torch.sign(torch.diagonal(r))
        return r * torch.where(s_ == 0, torch.ones_like(s_), s_)[:, None]

    r_diff = (sign_normalized(R.larray) - sign_normalized(r_lib)).abs().max().item() / r_lib.abs().max().item()
    check(r_diff <= QR_R_RTOL, f"qr R vs torch.linalg.qr's R: {r_diff}")
    ht.kernels.reset_kernel_stats()
    R_only = ht.linalg.qr(A, calc_q=False).R
    check(ht.KERNEL_STATS.get(qr_route) == 1, f"calc_q=False took another route: {dict(ht.KERNEL_STATS)}")
    r_only_diff = (R_only.larray - R.larray).abs().max().item() / r_lib.abs().max().item()
    check(R_only.split is None and r_only_diff <= QR_R_RTOL, f"qr(calc_q=False) R vs qr R: {r_only_diff}")
    G = ht.matmul(A.T, A)
    g_diff = (G.larray.double() - gram).abs().max().item() / gram.abs().max().item()
    check(G.shape == (F_QR, F_QR) and G.split is None and g_diff <= QR_GRAM_RTOL, f"matmul(A.T, A) vs float64 Gram: {g_diff}")
    print(f"[qr] A {N_QR} x {F_QR} float32 split=0: ht.linalg.qr route {qr_route} ({qr_s:.4f} s first call, peak "
          f"{qr_peak / 2**30:.2f} GiB allocated); Q split {A.split}, R split None; ||QR - A||max/||A||max {resid:.3e}; "
          f"||QᵀQ - I||max {ortho:.3e}; R vs torch.linalg.qr's R (row signs normalized) {r_diff:.3e} of max |R|; "
          f"calc_q=False R vs R {r_only_diff:.3e}; matmul(A.T, A) vs float64 Gram {g_diff:.3e} of max |G|", flush=True)
    del R_only, G, r_lib
    qr_flop = 2 * N_QR * F_QR * F_QR  # bench.py's accounting
    a_bytes = N_QR * F_QR * 4
    qr_times = {
        "ht.linalg.qr": time_ms(lambda: ht.linalg.qr(A), reps=5, warm=1),
        "ht.linalg.qr(calc_q=False)": time_ms(lambda: ht.linalg.qr(A, calc_q=False), reps=5, warm=1),
        "torch.linalg.qr(reduced)": time_ms(lambda: torch.linalg.qr(a_t, mode="reduced"), reps=5, warm=1),
        "torch.linalg.qr(r)": time_ms(lambda: torch.linalg.qr(a_t, mode="r"), reps=5, warm=1),
        "ht.matmul(A.T, A)": time_ms(lambda: ht.matmul(A.T, A), reps=10, warm=2),
        "torch.matmul(A.T, A)": time_ms(lambda: torch.matmul(a_t.T, a_t), reps=10, warm=2),
    }
    for name, ms in qr_times.items():
        flop = qr_flop if "qr" in name else 2 * N_QR * F_QR * F_QR
        print(f"[qr] {name}: {ms:.4f} ms, {flop / ms / 1e6:.1f} GFLOP/s at 2 m n^2 = {flop} flop", flush=True)
    print(f"[qr] bounds at 3.35 TB/s: read A + write Q (2 passes of {a_bytes} B) {2 * a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"CholeskyQR2 as written, {QR_CHOLQR2_PASSES} passes {QR_CHOLQR2_PASSES * a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"its 8 m n^2 flop at 67 TFLOP/s (float32 without TF32) {8 * N_QR * F_QR * F_QR / FP32_FLOP_PER_S * 1e3:.4f} ms; "
          f"matmul(A.T, A) reads A once {a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    del A, a_t, R, r64, qtq, gram
    torch.cuda.empty_cache()
    return kernels


if __name__ == "__main__":
    sys.exit(main())
