#!/usr/bin/env python3
"""Split the time of ``lloyd_fused``'s resident route on one CUDA card, and
time builds of it with other tile and ring sizes.

    python3 tools/torch_lloyd_split.py [--old OLD/heat_tpu_torch/core/kernels/csrc/lloyd.cu]
        [--variants 128x3,128x4,256x3,64x4]

Every build is one ``nvcc`` (all started together):

- the current ``heat_tpu_torch/core/kernels/csrc/lloyd.cu`` once per
  variant ``TILExSTAGES`` (``-DLLOYD_TILE``, ``-DLLOYD_STAGES``), run on
  the one-wave grid its occupancy query gives;
- ``--old``: an older ``lloyd.cu`` with the same C entry ``lloyd_fused``
  and no ring, run on its own grid of min(4 x SMs, n / 256) blocks;
- two probes: ``stage_old``, the older source's staging alone (256-row
  tiles moved by 4-byte ``__ldg`` loads into shared memory, a barrier,
  one read per thread, a barrier, on the older grid), and ``stream_read``,
  a float4 read of x summed in registers (what a plain read of the buffer
  takes on this card).

At the KMeans path's shape (n = 2^24 rows, f = 32, k = 8 float32 blobs,
made on the card from a seed), each build is timed with all rows valid
(``whole_ms``) and with
``n_valid = 0`` (``no_accumulate_ms``: the private-sum phase does no work,
every other phase runs), and its labels and counts are checked against
the plain ``assign_stats``. Times are CUDA events, the median of 25 single
launches after 3 warm-ups. Prints the card's name and power limit, then
one JSON line.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "heat_tpu_torch", "core", "kernels", "csrc", "lloyd.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
N, F, K = 1 << 24, 32, 8  # chip_smoke.py's KMeans path

PROBES = r"""
#include <cuda_runtime.h>
// the older lloyd.cu's staging loop alone: R = 256 / f rows per step, 4-byte __ldg loads
__global__ void __launch_bounds__(256)
stage_old(const float* __restrict__ x, long long n, int f, int ld, long long rows_per_block, float* __restrict__ out) {
    extern __shared__ float xs[];
    const int t = threadIdx.x, R = 256 / f, sg = t / f, sc = t - sg * f;
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
    float acc = 0.f;
    for (long long base = r0; base < r1; base += 256) {
        const int rows = static_cast<int>(r1 - base < 256 ? r1 - base : 256);
        if (sg < R) {
            const float* src = x + base * f;
            for (int rr = sg; rr < rows; rr += R) xs[rr * ld + sc] = __ldg(src + static_cast<long long>(rr) * f + sc);
        }
        __syncthreads();
        if (t < rows) acc += xs[t * ld + t % f];
        __syncthreads();
    }
    out[blockIdx.x * 256 + t] = acc;
}

__global__ void __launch_bounds__(256)
stream_read(const float4* __restrict__ x, long long n4, float* __restrict__ out) {
    float acc = 0.f;
    for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < n4; i += 256LL * gridDim.x) {
        const float4 v = __ldg(x + i);
        acc += v.x + v.y + v.z + v.w;
    }
    out[blockIdx.x * 256 + threadIdx.x] = acc;
}

extern "C" int probe(int which, const void* x, long long n, int f, int nblocks, void* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (which == 0) {
        const int ld = f | 1;
        const int smem = 256 * ld * 4;
        cudaFuncSetAttribute(stage_old, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        long long rpb = (n + nblocks - 1) / nblocks;
        rpb = (rpb + 255) / 256 * 256;
        stage_old<<<nblocks, 256, smem, s>>>(static_cast<const float*>(x), n, f, ld, rpb, static_cast<float*>(out));
    } else {
        stream_read<<<nblocks, 256, 0, s>>>(static_cast<const float4*>(x), n * f / 4, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
"""


def build(jobs, tmp):
    """Compile {name: (source, extra flags)} in parallel; return {name: CDLL}."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, (src, extra) in jobs.items():
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (subprocess.Popen([nvcc, *FLAGS, *extra, "-o", so, src], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="an older lloyd.cu without the ring, timed on its own grid")
    ap.add_argument("--variants", default="128x3,128x4,256x3,64x4", help="TILExSTAGES builds of the current source")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_lloyd_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from heat_tpu_torch.core.kernels import assign_stats

    n, f, k = N, F, K
    variants = [tuple(int(v) for v in s.split("x")) for s in args.variants.split(",") if s]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        probe_cu = os.path.join(tmp, "probes.cu")
        with open(probe_cu, "w") as fh:
            fh.write(PROBES)
        jobs = {f"tile{t}_stages{s}": (SOURCE, [f"-DLLOYD_TILE={t}", f"-DLLOYD_STAGES={s}"]) for t, s in variants}
        if args.old:
            jobs["old"] = (os.path.abspath(args.old), [])
        jobs["probes"] = (probe_cu, [])
        libs = build(jobs, tmp)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, lib in libs.items():
        if name == "probes":
            lib.probe.argtypes = [i32, p, i64, i32, i32, p, p]
            lib.probe.restype = i32
            continue
        lib.lloyd_fused.argtypes = [p, p, i64, i32, i32, i64, i32, p, p, p, p, p, p, p, i32, p]
        lib.lloyd_fused.restype = i32

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    cen = torch.randn(k, f, device=dev, generator=g) * 8.0
    x = cen[torch.randint(0, k, (n,), device=dev, generator=g)] + torch.randn(n, f, device=dev, generator=g)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums0, counts0, labels0, _ = assign_stats(x, cen)

    def time_ms(fn, reps=25, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)  # the host enqueues while the card is busy: device time only
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "n": n, "f": f, "k": k, "sms": sms, "builds": {}}
    old_grid = max(1, min(4 * sms, -(-n // 256)))
    for name, lib in libs.items():
        if name == "probes":
            continue
        if name == "old":
            tile, stages, per_sm, nblocks = 256, 1, None, old_grid
        else:
            lib.lloyd_tile.restype = lib.lloyd_stages.restype = i32
            lib.lloyd_blocks_per_sm.argtypes = [i32, i32, i32, i32]
            lib.lloyd_blocks_per_sm.restype = i32
            lib.lloyd_resident_smem.argtypes = [i32, i32]
            lib.lloyd_resident_smem.restype = i64
            tile, stages = lib.lloyd_tile(), lib.lloyd_stages()
            per_sm = lib.lloyd_blocks_per_sm(f, k, 1, 0)
            if per_sm < 1:
                out["builds"][name] = {"error": f"occupancy {per_sm}"}
                continue
            nblocks = min(sms * per_sm, -(-n // tile))
        labels = torch.empty(n, dtype=torch.int32, device=dev)
        part_sums = torch.empty((nblocks, k, f), dtype=torch.float32, device=dev)
        part_counts = torch.empty((nblocks, k), dtype=torch.int32, device=dev)
        part_inertia = torch.empty(nblocks, dtype=torch.float64, device=dev)
        sums = torch.empty((k, f), dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
        inertia = torch.empty(1, dtype=torch.float32, device=dev)

        def run(nv, lib=lib, nblocks=nblocks, labels=labels, part_sums=part_sums, part_counts=part_counts,
                part_inertia=part_inertia, sums=sums, counts=counts, inertia=inertia):
            err = lib.lloyd_fused(x.data_ptr(), cen.data_ptr(), n, f, k, nv, nblocks, labels.data_ptr(),
                                  part_sums.data_ptr(), part_counts.data_ptr(), part_inertia.data_ptr(),
                                  sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), 0, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

        run(n)
        torch.cuda.synchronize()
        rec = {
            "tile": tile, "stages": stages, "blocks_per_sm": per_sm, "grid": nblocks,
            "labels_differing": int((labels != labels0).sum()), "counts_equal": bool(torch.equal(counts, counts0)),
            "sums_max_rel": float((sums - sums0).abs().max() / sums0.abs().max()),
            "whole_ms": time_ms(lambda: run(n)), "no_accumulate_ms": time_ms(lambda: run(0)),
        }
        if name != "old":
            rec["bytes_in_flight_per_sm"] = per_sm * (stages - 1) * tile * f * 4
        out["builds"][name] = rec
        print(f"[split] {name}: {rec}", flush=True)
    scratch = torch.empty(max(old_grid, sms * 8) * 256, dtype=torch.float32, device=dev)

    def probe(which, nblocks):
        err = libs["probes"].probe(which, x.data_ptr(), n, f, nblocks, scratch.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"probe {which}: launch failed with CUDA error {err}")

    out["stage_old_ms"] = time_ms(lambda: probe(0, old_grid))
    out["stream_read_ms"] = time_ms(lambda: probe(1, sms * 8))
    out["read_bound_ms"] = n * f * 4 / 3.35e12 * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
