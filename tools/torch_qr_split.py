#!/usr/bin/env python3
"""Split the time of ``heat_tpu_torch.linalg.qr``'s CholeskyQR2 route into
its steps, on one CUDA card, and time two other ways to apply a triangular
factor's inverse.

    python3 tools/torch_qr_split.py [--m 16777216] [--n 64] [--seed 2]

A is m x n float32 with Gaussian entries (its own generator, seeded), in
full float32 products (no TF32). Times are CUDA events, the median of 5
calls after 1 warm-up: the whole ``qr``; a Gram ``v.mT @ v``; the (n, n)
``torch.linalg.cholesky_ex``; the triangular solve ``q = v L^-T`` as
``qr`` calls it, a left solve on the column-major view ``vᵀ``
(``solve_triangular(L, v.mT, upper=False).mT``), and as the right solve
(``solve_triangular(L.mT, v, upper=True, left=False)``); and, for
context, ``v @ inv(L^T)`` (a product with an explicit inverse, which is
not a triangular solve). For each way of
solving it also runs the two CholeskyQR2 passes and prints
``||QᵀQ - I||max`` in float64. Prints one JSON line last.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(fn, reps=5, warm=1):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1 << 24)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qr_split: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht

    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] {smi} torch={torch.__version__}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    a = torch.randn(args.m, args.n, device=dev, generator=gen)
    A = ht.array(a, split=0, copy=False)
    L = torch.linalg.cholesky_ex(a.mT @ a)[0]

    solves = {
        "solve_left_transposed": lambda v, l: torch.linalg.solve_triangular(l, v.mT, upper=False).mT,
        "solve_right": lambda v, l: torch.linalg.solve_triangular(l.mT, v, upper=True, left=False),
        "inverse_product": lambda v, l: v @ torch.linalg.inv(l.mT),
    }
    out = {"device": smi, "m": args.m, "n": args.n}
    out["qr_ms"] = time_ms(lambda: ht.linalg.qr(A))
    out["gram_ms"] = time_ms(lambda: a.mT @ a)
    g = a.mT @ a
    out["cholesky_ex_ms"] = time_ms(lambda: torch.linalg.cholesky_ex(g))
    for name, solve in solves.items():
        out[f"{name}_ms"] = time_ms(lambda: solve(a, L))
        q1 = solve(a, torch.linalg.cholesky_ex(a.mT @ a)[0])
        q2 = solve(q1, torch.linalg.cholesky_ex(q1.mT @ q1)[0])
        qtq = torch.zeros(args.n, args.n, dtype=torch.float64, device=dev)
        for r0 in range(0, args.m, 1 << 22):
            qc = q2[r0 : r0 + (1 << 22)].double()
            qtq += qc.T @ qc
        out[f"{name}_ortho"] = float((qtq - torch.eye(args.n, dtype=torch.float64, device=dev)).abs().max())
        out[f"{name}_contiguous"] = bool(q2.is_contiguous())
        del q1, q2
        print(f"[split] {name}: {out[f'{name}_ms']:.4f} ms per solve; two CholeskyQR2 passes give "
              f"||QᵀQ - I||max {out[f'{name}_ortho']:.3e}", flush=True)
    print(f"[split] qr {out['qr_ms']:.4f} ms = about 3 Grams of {out['gram_ms']:.4f} ms + 2 cholesky_ex of "
          f"{out['cholesky_ex_ms']:.4f} ms + 2 solves of {out['solve_left_transposed_ms']:.4f} ms (+ small products)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
