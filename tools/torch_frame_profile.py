#!/usr/bin/env python3
"""Profile ``Frame.groupby(...).agg(...)`` of heat_tpu_torch on one CUDA card.

    python3 tools/torch_frame_profile.py [--seed S]

The data is ``chip_smoke.py``'s ``[frame]`` lineitem: TPC-H at SF 10 made with
numpy from the seed (6.0e7 rows), grouped by ``l_orderkey`` (1.5e7 groups) with
sum, mean, min, max, std and count of three float32 columns. After one warm
call per mode, one range-mode and one hash-mode groupby run under
``torch.profiler`` (CPU and CUDA activities). Prints the card's name and power
limit, each mode's host s, the device's busy share (the CUDA time of every
kernel and copy over the call's host time), the top device operators by CUDA
time, and then one JSON line with the same numbers.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed (default 0)")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import heat_tpu_torch as ht

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ht.use_device("gpu")
    _, li, _ = chip_smoke.tpch_sf10(args.seed + chip_smoke.FRAME_SEED_OFFSET)
    G = ht.Frame({c: ht.array(li[c], split=0) for c in ("l_orderkey",) + chip_smoke.FRAME_VALUES})
    out = {"card": smi, "rows": int(li["l_orderkey"].size)}
    for mode in ("range", "hash"):
        G.groupby("l_orderkey", mode=mode).agg(chip_smoke.FRAME_SPEC)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            G.groupby("l_orderkey", mode=mode).agg(chip_smoke.FRAME_SPEC)
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
        events = prof.key_averages()
        ops = [e for e in events if e.device_type == DeviceType.CPU]  # each op carries its kernels' device time
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in (kernels or ops))
        top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]
        rows = [{"op": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3} for e in top
                if e.self_device_time_total > 0]
        out[mode] = {"host_s": host, "device_ms": device_us / 1e3, "busy_share": device_us / 1e6 / host,
                     "top": rows}
        print(f"[{mode}] host {host:.4f} s, device {device_us / 1e3:.4f} ms, busy share "
              f"{device_us / 1e6 / host:.3f}; top device operators: " + "; ".join(
                  f"{r['op']} x{r['calls']} {r['device_ms']:.3f} ms" for r in rows), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
