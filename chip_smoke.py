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
   shapes, main-path shapes included, with the tolerances below.
4. The main path at full width: 8 Gaussian blobs, n = 2^24 rows x f = 32
   float32 (2 GiB; ``bench.py``'s k, f and iteration count at 32x its rows),
   ``mean``/``std`` along axis 0, standardize, ``KMeans(8, init=8 rows of z,
   max_iter=30, tol=None).fit``, ``predict`` on 2^20 held-out rows. Kernel
   launch counts are zeroed just before and read just after, and the fit is
   held against the same fit through the plain versions.
5. Timing with CUDA events (median of 25 single launches after warm-up):
   kernel, plain version, one-call library yardstick where one exists, and
   the bound of each kernel at its main-path shape.

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

# ---- the card's peaks (NVIDIA H100 SXM data sheet) --------------------------
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_MAIN, F_MAIN, K_MAIN, ITERS = 1 << 24, 32, 8, 30
N_PREDICT = 1 << 20


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import _build, assign_stats, chunk_moments, forced_mode, lloyd_local, moments_local
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
    check(set(built) >= {"moments", "lloyd"}, f"built {sorted(built)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
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
    for n, f, k, nv in [(N_MAIN, F_MAIN, K_MAIN, N_MAIN), (1_000_003, 18, 5, 999_000), (65_536, 64, 64, 65_536), (7, 3, 2, 7)]:
        cen = torch.randn(k, f, device=dev, generator=gen) * 8.0
        truth = torch.randint(0, k, (n,), device=dev, generator=gen)
        x = cen[truth] + torch.randn(n, f, device=dev, generator=gen)
        sums, counts, labels, inertia = lloyd_local(x, cen, nv)
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
        print(f"[check] lloyd_fused n={n} f={f} k={k} n_valid={nv}: counts exact, labels differ on {int(diff.sum())} rows "
              f"({int(near.sum())} near-tie rows), sums max abs {e_sums:.3e} (max |sum| {sums0.abs().max().item():.3e}), "
              f"inertia rel {e_in / max(abs(float(inertia0)), 1e-30):.3e}, bit-identical rerun", flush=True)
        if n == N_MAIN:
            errors["lloyd_fused"] = max(e_sums, e_in)
        del x, d2
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
    del d2, two, near, ldiff, lab0, km0, mu0, sd0, x_new, pred
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 5. timing
    def time_ms(fn, reps=25, warm=3):
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
    t0 = time.perf_counter()
    ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    print(f"[time] warm fit {warm_fit_s:.4f} s ({ITERS / warm_fit_s:.1f} iterations/s, {ITERS + 1} lloyd launches)", flush=True)

    kernels = []
    for name in ("moments_onepass", "lloyd_fused"):
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
