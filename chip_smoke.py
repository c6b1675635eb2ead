#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check every kernel.

Run from the repository root, with no arguments, on a machine with an
NVIDIA Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Environment: the card, its power limit, torch and CUDA versions.
2. Build: every ``heat_tpu_torch/core/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (in parallel), with ptxas' register / shared-memory report.
3. Each kernel against its plain PyTorch version on the card, at several
   shapes, main-path shapes included, with the tolerances below;
   ``lloyd_fused`` on both of its routes (``resident`` and ``general``),
   f up to 4097 and k * f past 8192.
4. Three paths at full width, each with its kernel launch counts zeroed
   just before and read just after, and held against the same path
   through the plain versions:
   - KMeans: 8 Gaussian blobs, n = 2^24 rows x f = 32 float32 (2 GiB;
     ``bench.py``'s k, f and iteration count at 32x its rows),
     ``mean``/``std`` along axis 0, standardize, ``KMeans(8, init=8 rows
     of z, max_iter=30, tol=None).fit``, ``predict`` on 2^20 held-out rows;
   - kNN: ``KNeighborsClassifier(n_neighbors=5).fit`` on the first 2^22
     standardized rows (512 MiB) with the fit's labels, ``predict`` on 2^13
     held-out standardized rows; then ``spatial.nearest_neighbors`` at
     k = 100 (above the kernel's shared-memory lists) on the same data;
   - kernel ridge: ``K = rbf(X, X, sigma=sqrt(32)) + eye(1024)`` over the
     first 1024 standardized rows, ``L = cholesky(K)``, then
     ``alpha = solve_triangular(L.T, solve_triangular(L, y, lower=True))``;
   - and a wide fit beside the paths: ``KMeans(16, max_iter=10,
     tol=None).fit`` on 16 blobs of n = 2^20 rows x f = 160, which takes
     ``lloyd_fused``'s general route, held against the plain fit.
5. Timing with CUDA events (median of single launches after warm-up; the
   repetitions are named per kernel): kernel, plain version, one-call
   library yardstick where one exists, and the bound of each kernel at its
   main-path shape (bytes over 3.35 TB/s or float32 flops over 67
   TFLOP/s). ``[design]`` lines name each redesigned kernel's launch plan.

The line before last is one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
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
# kNN: distances as heat_tpu's own kNN tests hold them; an index may differ
# only where the plain version's distances of the two rows are within
# KNN_TIE_RTOL of each other, relative to (d + 1): the card, cuBLAS and XLA
# round (x2 + y2) - 2 xy differently in the last bits
KNN_RTOL, KNN_ATOL = 1e-4, 1e-5
KNN_TIE_RTOL = 1e-5
# Cholesky, kernel vs plain version: the same steps with float32 sums of up
# to n terms in another order (fmaf chains vs cuBLAS), relative to max |L|
CHOL_ATOL_REL = 2e-5
# kernel ridge: ||L L^T - K||max / ||K||max is float32 Cholesky's backward
# error, c n eps ~ 1e-4 at n = 1024 in the worst case; ||K a - y|| / ||y|| is
# that error times the condition of K (at most 1 + ||rbf|| ~ 1e3 here)
RIDGE_RECON_RTOL = 1e-4
RIDGE_SOLVE_RTOL = 1e-2

# ---- the card's peaks (NVIDIA H100 SXM data sheet) --------------------------
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_MAIN, F_MAIN, K_MAIN, ITERS = 1 << 24, 32, 8, 30
N_PREDICT = 1 << 20
N_TRAIN, N_QUERY, KNN_K = 1 << 22, 1 << 13, 5  # kNN path
N_RIDGE = 1024                                 # kernel-ridge path: heat_tpu's MAX_FUSED_N
N_WIDE, F_WIDE, K_WIDE, ITERS_WIDE = 1 << 20, 160, 16, 10  # the wide fit: lloyd_fused's general route


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def knn_check(x, y, d, i, d0, i0):
    """Distances within KNN_RTOL/KNN_ATOL and indices equal outside
    near-ties; returns (max abs distance error, differing entries)."""
    import torch

    from heat_tpu_torch.spatial.distance import _quadratic_expand

    e = (d - d0).abs()
    check(bool((e <= KNN_ATOL + KNN_RTOL * d0.abs()).all()), f"kNN distances differ by up to {e.max().item()}")
    diff = i != i0
    rows = torch.nonzero(diff.any(dim=1)).flatten()
    for r0 in range(0, rows.numel(), 64):
        rr = rows[r0 : r0 + 64]
        full = _quadratic_expand(x[rr], y)
        dk, dp = torch.gather(full, 1, i[rr].long()), torch.gather(full, 1, i0[rr].long())
        check(bool(((dk - dp).abs() <= KNN_TIE_RTOL * (dp.abs() + 1.0)).all()), "kNN indices differ outside near-ties")
    return e.max().item(), int(diff.sum())


def spd(n, gen, dev):
    import torch

    g = torch.randn(n, n, device=dev, generator=gen, dtype=torch.float64)
    return (g @ g.T / n + torch.eye(n, device=dev, dtype=torch.float64)).to(torch.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import (
        _build, assign_stats, chol_block_size, chol_panels, cholesky_local, chunk_moments, forced_mode, knn_tiles,
        lloyd_local, lloyd_route, moments_local, nearest_neighbors_local, resident_smem,
    )
    from heat_tpu_torch.core.kernels import lloyd, panel_update, topk_distance
    from heat_tpu_torch.spatial.distance import _quadratic_expand

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
    check(set(built) >= {"moments", "lloyd", "topk_distance", "panel_update"}, f"built {sorted(built)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the checks of lloyd_fused's routes past the resident one draw from their own stream, so
    # every path's data is what it was before they were added
    gen_routes = torch.Generator(device=dev)
    gen_routes.manual_seed(1)
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
        e_d, ndiff = knn_check(x, y, d, i, d0, i0)
        again = nearest_neighbors_local(x, y, k)
        check(torch.equal(again[0], d) and torch.equal(again[1], i), f"kNN not bit-identical from run to run at {(n, m, f, k)}")
        print(f"[check] topk_distance n={n} m={m} f={f} k={k}: distances max abs {e_d:.3e}, indices differ on {ndiff} "
              f"entries (all near-ties), bit-identical rerun", flush=True)
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
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 4. main path
    ht.use_device("gpu")
    ht.random.seed(0)
    true_centers = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    member = torch.randint(0, K_MAIN, (N_MAIN + N_PREDICT,), device=dev, generator=gen)
    member[:K_MAIN] = torch.arange(K_MAIN, device=dev)  # rows 0..7: one of each blob, the init rows
    x = ht.random.randn(N_MAIN, F_MAIN, split=0) + ht.array(true_centers.larray[member[:N_MAIN]], split=0, copy=False)
    x_new = ht.random.randn(N_PREDICT, F_MAIN, split=0) + ht.array(true_centers.larray[member[N_MAIN:]], split=0, copy=False)
    torch.cuda.synchronize()

    ht.kernels.reset_kernel_stats()
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
    print(f"[main] mean+std+standardize+fit+predict {main_s:.3f} s; fit {fit_s:.3f} s "
          f"({ITERS / fit_s:.1f} iterations/s) at n={N_MAIN} f={F_MAIN} k={K_MAIN}", flush=True)
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
    e_q, nd_q = knn_check(zq.larray, train.larray, dq.larray, iq.larray, dq0.larray, iq0.larray)
    pdiff = knn_pred.larray != knn_pred0.larray
    check(not bool((pdiff & ~(iq.larray != iq0.larray).any(dim=1)).any()),
          "kNN labels differ from the plain predict where the neighbours are the same")
    print(f"[knn] accuracy against the blobs {knn_acc:.6f}; vs plain predict ({knn_plain_s:.3f} s): labels differ on "
          f"{int(pdiff.sum())} rows, neighbour indices on {nd_q} entries (near-ties only), distances max abs {e_q:.3e}",
          flush=True)
    del dq, iq, dq0, iq0, knn_pred0
    # k above the kernel's shared-memory lists: heat_tpu answers any k <= m, and so does the port on a card.
    # At k = 100 some ranks hold rows whose distances differ by two roundings of |x|^2 + |y|^2 (about 64
    # here), more than KNN_TIE_RTOL of d + 1; so an index may differ where the plain version's distances
    # of the two rows agree within the distance tolerance, and the entries past KNN_TIE_RTOL are counted.
    dq, iq = ht.spatial.nearest_neighbors(zq, train, 100)
    dq0, iq0 = knn_tiles(zq.larray, train.larray, 100)
    check(tuple(iq.shape) == (N_QUERY, 100) and iq.larray.dtype == torch.int32, f"nearest_neighbors k=100 {tuple(iq.shape)}")
    d1, i1 = dq.larray, iq.larray
    e_100 = (d1 - dq0).abs()
    check(bool((e_100 <= KNN_ATOL + KNN_RTOL * dq0.abs()).all()), f"k=100 distances differ by up to {e_100.max().item()}")
    rows = torch.nonzero((i1 != iq0).any(dim=1)).flatten()
    past_tie = 0
    for r0 in range(0, rows.numel(), 64):
        rr = rows[r0 : r0 + 64]
        full = _quadratic_expand(zq.larray[rr], train.larray)
        dk, dp = torch.gather(full, 1, i1[rr].long()), torch.gather(full, 1, iq0[rr].long())
        check(bool(((dk - dp).abs() <= KNN_ATOL + KNN_RTOL * dp.abs()).all()), "k=100 indices differ beyond the distance tolerance")
        past_tie += int(((dk - dp).abs() > KNN_TIE_RTOL * (dp.abs() + 1.0)).sum())
    print(f"[knn] spatial.nearest_neighbors k=100 on the kNN path's data vs knn_tiles: distances max abs "
          f"{e_100.max().item():.3e}, indices differ on {int((i1 != iq0).sum())} entries, all within the distance "
          f"tolerance; {past_tie} of them past KNN_TIE_RTOL", flush=True)
    del dq, iq, dq0, iq0, d1, i1

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
    def time_ms(fn, reps=25, warm=3):
        # the median of `reps` single launches after `warm` unmeasured ones
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
    t0 = time.perf_counter()
    ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    print(f"[time] warm fit {warm_fit_s:.4f} s ({ITERS / warm_fit_s:.1f} iterations/s, {ITERS + 1} lloyd launches)", flush=True)

    kernels = []
    for name in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused"):
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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
