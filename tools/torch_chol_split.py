#!/usr/bin/env python3
"""Split the time of the multi-kernel ``chol_panel_fused`` design (one
copy kernel, then per panel ``chol_diag``, ``chol_panel`` and
``chol_trailing``) into its three per-panel steps, on one CUDA card.

That design was replaced by one persistent kernel; its source is the
``csrc/panel_update.cu`` of an older checkout. Give that file's path:

    python3 tools/torch_chol_split.py OLD/heat_tpu_torch/core/kernels/csrc/panel_update.cu [--n 1024] [--bs 128]

The source is compiled with a small harness that includes it (so its
kernels, in an anonymous namespace, are reachable) and times with CUDA
events, on an SPD matrix of order n: the whole call; each step's launches
for all panels enqueued alone (the diagonal step's share is what the
redesign's register-resident diagonal factor removes); and the copy. Each
figure is the median of 25 runs after 3 warm-ups. Prints one JSON line.
"""
import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

HARNESS = r"""
#include "%(src)s"
#include <cuda_runtime.h>
// which: 0 the whole call, 1 chol_diag only, 2 chol_panel only, 3 chol_trailing only, 4 the copy only
extern "C" int split_run(const void* a, void* L, int n, int bs, int which, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (which == 0) return chol_panel_fused(a, L, n, bs, 0, stream);
    const int diag_smem = static_cast<int>(sizeof(float)) * kMaxBs * (kMaxBs + 1);
    const int panel_smem = diag_smem + static_cast<int>(sizeof(float)) * kPanelWarps * kMaxBs;
    cudaFuncSetAttribute(chol_diag, cudaFuncAttributeMaxDynamicSharedMemorySize, diag_smem);
    cudaFuncSetAttribute(chol_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, panel_smem);
    float* l = static_cast<float*>(L);
    if (which == 4) {
        const long long nn = static_cast<long long>(n) * n;
        const long long blocks = (nn + kCopyThreads - 1) / kCopyThreads;
        chol_copy_lower<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kCopyThreads, 0, s>>>(
            static_cast<const float*>(a), l, n);
    }
    for (int off = 0; off < n && which != 4; off += bs) {
        const int nb = n - off < bs ? n - off : bs;
        const int below = n - off - nb;
        if (which == 1) chol_diag<<<1, kDiagThreads, sizeof(float) * nb * (nb + 1), s>>>(l, n, off, nb);
        if (below <= 0) break;
        if (which == 2)
            chol_panel<<<(below + kPanelWarps - 1) / kPanelWarps, kPanelWarps * 32,
                         sizeof(float) * (nb * (nb + 1) + kPanelWarps * nb), s>>>(l, n, off, nb);
        if (which == 3) {
            const int nt = (below + kTT - 1) / kTT;
            chol_trailing<<<dim3(nt, nt), kTThreads, 0, s>>>(l, n, off, nb);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="panel_update.cu of the multi-kernel design")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--bs", type=int, default=128)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_chol_split: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        cu = os.path.join(tmp, "split.cu")
        with open(cu, "w") as fh:
            fh.write(HARNESS % {"src": os.path.abspath(args.source)})
        so = os.path.join(tmp, "libsplit.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.split_run.argtypes = [p, p, i32, i32, i32, p]
    lib.split_run.restype = i32

    dev = torch.device("cuda", 0)
    n = args.n
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.randn(n, n, device=dev, generator=g, dtype=torch.float64)
    a = (m @ m.T / n + torch.eye(n, device=dev, dtype=torch.float64)).to(torch.float32)
    L = torch.empty_like(a)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(which):
        err = lib.split_run(a.data_ptr(), L.data_ptr(), n, args.bs, which, stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    def time_ms(which, reps=25, warm=3):
        for _ in range(warm):
            run(which)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)  # the host enqueues while the card is busy: device time only
            e0.record()
            run(which)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "n": n, "bs": args.bs}
    for name, which in (("whole_ms", 0), ("diag_ms", 1), ("panel_ms", 2), ("trailing_ms", 3), ("copy_ms", 4)):
        out[name] = time_ms(which)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
