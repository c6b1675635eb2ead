#!/usr/bin/env python3
"""Measure ``lazy_fused`` (and ``threefry_bits``' draws) on one CUDA card.

    python3 tools/lazy_fused_probe.py [--root CHECKOUT] [--label NAME] [--out FILE.json]
        [--sass DIR] [--parts ptxas,sweep,segments,host,threefry]

``--root`` names the checkout whose ``heat_tpu_torch`` is imported (default:
this one), so that two trees can be measured in one call, in turns. Parts:

- ``ptxas``: the ``-Xptxas -v`` report of every ``lazy_fused`` kernel
  (registers, stack frame, spills, shared memory), from the build's log.
- ``sweep``: synthetic segments over 2^24 x 32 float32 (one flat input):
  programs of 1, 2, 4, 8, 16 and 32 ``add``/``mul`` instructions with
  immediates, and again with their first 1 or 2 instructions adding a
  broadcast row (1, 32). CUDA-event ms each (median of 10 after 2 warm
  calls), the least-squares slope in ms per instruction and the cost per
  row; every program checked bit for bit against ``lazy_fused_plain`` at a
  tail size ((2^20 + 7) x 32).
- ``segments``: the ``[lazy]`` chains of ``chip_smoke.py`` (captured with
  ``ht.lazy()`` on 2^24 x 32 float32), each ``lazy_fused`` call timed as
  above beside its bytes bound.
- ``host``: the warm host microseconds of one ``lazy_fused`` call (the
  median of 400, no synchronise inside) at the serve buckets of 1 and 256
  rows of ``(rows - mu) / sd``, and, where the binding caches its plans,
  of the C call alone (the launch).
- ``threefry``: ``threefry_bits``' float32 normal draw and its four 16-bit
  kinds at (2^24, 32), timed as above.

``--sass DIR`` writes ``cuobjdump -sass`` of ``liblazy_fused.so`` and
``libthreefry.so`` there and counts each function's instructions by pipe
(see :func:`sass_counts`); ``--count-sass FILE`` does only that counting, on
a dump made earlier (no card needed), or with ``--function F --ranges
a-b,...`` counts one executed path of a function (:func:`path_counts`).
Prints the card's name, power limit and SM clock, then one JSON line (also
written to ``--out``).
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 1 << 24, 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SWEEP_COUNTS = (1, 2, 4, 8, 16, 32)

# SASS opcodes by the pipe that issues them on Hopper (an approximation from NVIDIA's public descriptions: the
# FMA pipe takes float32 multiply-adds and IMAD; the ALU integer adds, logic, shifts, compares and selects)
FMA_PIPE = ("FFMA", "FMUL", "FADD", "IMAD", "HFMA2", "HMUL2", "HADD2", "FSWZADD")
ALU_PIPE = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "IMNMX", "SEL", "PRMT", "FSETP", "FSEL", "FMNMX", "IABS", "LOP",
            "SHL", "SHR", "FLO", "POPC", "BMSK", "PLOP3", "P2R", "R2P", "VIADD", "VIMNMX", "MOV", "IADD")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps=10, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # the card stays busy while the host enqueues
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sass_counts(text):
    """Per function of a ``cuobjdump -sass`` dump: instructions in all, and in its largest loop (the span of its
    longest backward branch), each by pipe (fma / alu / other) and by opcode."""
    out, name, ins, labels, pending = {}, None, [], {}, []

    def close():
        if name is None:
            return
        resolved = [(a, op, labels.get(t, t) if isinstance(t, str) else t) for a, op, t in ins]
        loops = [(t, a) for a, op, t in resolved if op.startswith("BRA") and t is not None and t < a]
        body = resolved
        if loops:
            lo, hi = max(loops, key=lambda p: p[1] - p[0])
            body = [i for i in resolved if lo <= i[0] <= hi]
        out[name] = {"all": _classify([op for _, op, _ in resolved]), "loop": _classify([op for _, op, _ in body]),
                     "loops": len(loops)}

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, ins, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and name is not None:
            addr, op = int(m.group(1), 16), m.group(2)
            for lab in pending:
                labels[lab] = addr
            pending = []
            if op == "NOP":
                continue
            tgt = None
            if op.startswith("BRA"):
                t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", m.group(3))
                if t is not None:
                    tgt = t.group(1) or int(t.group(2), 16)
            ins.append((addr, op, tgt))
    close()
    return out


def path_counts(text, function, ranges):
    """Instructions by pipe on one executed path of a function: the union of address ranges ``a-b`` (ends
    included), read off its dump (for a loop body, the branches its common case takes)."""
    spans = [tuple(int(v, 16) for v in r.split("-")) for r in ranges.split(",")]
    ops, inside = [], False
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            inside = function in m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m and m.group(2) != "NOP":
            addr = int(m.group(1), 16)
            if any(a <= addr <= b for a, b in spans):
                ops.append(m.group(2))
    return _classify(ops)


def _classify(ops):
    by = {"fma": 0, "alu": 0, "other": 0}
    hist = {}
    for op in ops:
        base = op.split(".")[0]
        hist[base] = hist.get(base, 0) + 1
        by["fma" if base in FMA_PIPE else "alu" if base in ALU_PIPE else "other"] += 1
    by["total"] = len(ops)
    by["opcodes"] = dict(sorted(hist.items(), key=lambda kv: -kv[1]))
    return by


def cuobjdump():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for c in (os.path.join(home, "bin", "cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if os.path.isfile(c):
            return c
    raise RuntimeError("cuobjdump not found")


def sweep_programs(SegmentProgram, torch):
    """(k, rows, program): k add/mul instructions on input 0, the first ``rows`` of them adding a broadcast row."""
    progs = []
    for rows in (0, 1, 2):
        n_in = 1 + rows
        for k in SWEEP_COUNTS:
            if k < rows:
                continue
            instrs = []
            for j in range(k):
                a = 0 if j == 0 else n_in + j - 1
                if j < rows:
                    instrs.append(("add", n_in + j, a, 1 + j, 0.0, False))
                elif j % 2:
                    instrs.append(("mul", n_in + j, a, -1, 0.9990234375, False))
                else:
                    instrs.append(("add", n_in + j, a, -1, 0.25, False))
            progs.append((k, rows, SegmentProgram(n_in, tuple(instrs), ((n_in + k - 1, torch.float32),))))
    return progs


def fit_slope(points):
    """Least-squares slope and intercept of (x, y) points."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    sxx = sum((x - mx) ** 2 for x, _ in points)
    slope = sum((x - mx) * (y - my) for x, y in points) / sxx
    return slope, my - slope * mx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None)
    ap.add_argument("--count-sass", default=None, help="a cuobjdump -sass dump to count (no card needed)")
    ap.add_argument("--function", default="", help="with --ranges: a substring of the function's name")
    ap.add_argument("--ranges", default="", help="with --count-sass: the address ranges of one executed path, "
                                                 "e.g. 0x330-0x390,0x5d0-0xc00 (both ends included)")
    ap.add_argument("--parts", default="ptxas,sweep,segments,host,threefry")
    args = ap.parse_args(argv)
    if args.count_sass:
        with open(args.count_sass) as f:
            text = f.read()
        if args.ranges:
            print(json.dumps(path_counts(text, args.function, args.ranges), indent=1))
        else:
            print(json.dumps(sass_counts(text), indent=1))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lazy_fused_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import _build, lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram, segment_bytes
    from heat_tpu_torch.core.lazy import evaluate as lev

    parts = set(args.parts.split(","))
    card = smi()
    print(f"[probe {args.label}] {card} torch {torch.__version__} root {os.path.abspath(args.root)}", flush=True)
    print(card.split(",")[0] + "," + card.split(",")[1], flush=True)
    dev = torch.device("cuda", 0)
    ht.use_device("gpu")
    t0 = time.perf_counter()
    built = _build.build_all()
    res = {"label": args.label, "card": card, "build_s": time.perf_counter() - t0}
    describe = getattr(sys.modules["heat_tpu_torch.core.kernels.lazy_fused"], "describe", None)
    if "ptxas" in parts:
        res["ptxas"] = built["lazy_fused"].ptxas
        for line in built["lazy_fused"].ptxas:
            print(f"[probe {args.label}] ptxas {line}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        res["sass"] = {}
        for name in ("lazy_fused", "threefry"):
            text = subprocess.run([cuobjdump(), "-sass", str(built[name].path)], capture_output=True, text=True,
                                  check=True).stdout
            with open(os.path.join(args.sass, f"{args.label}_{name}.sass"), "w") as f:
                f.write(text)
            counts = sass_counts(text)
            res["sass"][name] = {k: {"all": v["all"]["total"], "loop": v["loop"]["total"],
                                     "loop_fma": v["loop"]["fma"], "loop_alu": v["loop"]["alu"],
                                     "loop_other": v["loop"]["other"]} for k, v in counts.items()}
            for k, v in res["sass"][name].items():
                print(f"[probe {args.label}] sass {name} {k}: {v}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    x = torch.randn(N, F, device=dev, generator=gen) * 4.0 + 1.0
    bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    if "sweep" in parts:
        row1 = torch.randn(1, F, device=dev, generator=gen)
        row2 = torch.randn(1, F, device=dev, generator=gen).abs() + 1.0
        xt = torch.randn((1 << 20) + 7, F, device=dev, generator=gen)
        sweep = []
        for k, rows, prog in sweep_programs(SegmentProgram, torch):
            ins = [x, row1, row2][: 1 + rows]
            tail = [xt, row1, row2][: 1 + rows]
            (got,) = lazy_fused(prog, tail, tuple(xt.shape))
            (want,) = lazy_fused_plain(prog, tail, tuple(xt.shape))
            same = bool(torch.equal(got, want))
            ms = time_ms(lambda: lazy_fused(prog, ins, (N, F)))
            info = describe(prog, ins, (N, F)) if describe else None
            sweep.append({"instructions": k, "rows": rows, "ms": ms, "share": bound / ms, "tail_bit_for_bit": same,
                          "design": info})
            print(f"[probe {args.label}] sweep {k} instructions, {rows} broadcast rows: {ms:.4f} ms (share "
                  f"{bound / ms:.3f} of {bound:.4f}); tail (2^20+7)x32 bit for bit {same}"
                  + (f"; {info}" if info else ""), flush=True)
            del got, want
        fits = {}
        for rows in (0, 1, 2):
            pts = [(s["instructions"], s["ms"]) for s in sweep if s["rows"] == rows]
            fits[f"rows{rows}"] = fit_slope(pts)
            fits[f"rows{rows}_to8"] = fit_slope([p for p in pts if p[0] <= 8])
        per_row = [s1["ms"] - s0["ms"] for s0 in sweep if s0["rows"] == 0 for s1 in sweep
                   if s1["rows"] == 1 and s1["instructions"] == s0["instructions"]]
        res["sweep"] = sweep
        res["sweep_fit"] = {k: {"ms_per_instruction": v[0], "intercept_ms": v[1]} for k, v in fits.items()}
        res["ms_per_row"] = statistics.median(per_row)
        print(f"[probe {args.label}] sweep fit (ms per instruction, intercept): "
              + ", ".join(f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in fits.items())
              + f"; a broadcast row (median over k) {res['ms_per_row']:.4f} ms", flush=True)
        del xt, row1, row2
        torch.cuda.empty_cache()

    if "segments" in parts:
        xa = ht.array(x, split=0, copy=False)
        chains = {
            "standardize": lambda a: (a - ht.mean(a, axis=0)) / (ht.std(a, axis=0) + 1.0),
            "score": lambda a: ht.sum((a * a - 1.0) * 0.5, axis=0),
            "elementwise": lambda a: ht.exp(-ht.abs(a)) * 2.0 + 1.0,
            "mean_all": lambda a: a - ht.mean(a),
            "var_norm": lambda a: a / (ht.var(a, axis=0) + 1.0),
            "cumsum": lambda a: ht.cumsum(a * 3.0, axis=0),
        }
        segs = {}
        orig = lev.lazy_fused
        for name, chain in chains.items():
            calls = []

            def rec(prog, inputs, shape, reduce=False, calls=calls):
                outs = orig(prog, inputs, shape, reduce)
                calls.append((prog, list(inputs), tuple(shape), reduce))
                return outs

            lev.lazy_fused = rec
            try:
                with ht.lazy():
                    r = chain(xa)
                r.larray
                torch.cuda.synchronize()
            finally:
                lev.lazy_fused = orig
            rows = []
            for prog, inputs, shape, reduce in calls:
                ms = time_ms(lambda: lazy_fused(prog, inputs, shape, reduce))
                moved = segment_bytes(prog, inputs, shape) if reduce is False else sum(
                    t.numel() * t.element_size() for t in inputs)
                b = moved / HBM_BYTES_PER_S * 1e3
                info = describe(prog, inputs, shape, reduce) if describe else None
                rows.append({"instructions": len(prog.instrs), "summed": reduce is not False, "ms": ms,
                             "bound_ms": b, "share": b / ms, "design": info})
                print(f"[probe {args.label}] segment {name}: {len(prog.instrs)} instructions"
                      f"{' summed' if reduce is not False else ''}: {ms:.4f} ms vs bound {b:.4f} (share {b / ms:.3f})"
                      + (f"; {info}" if info else ""), flush=True)
            segs[name] = rows
        res["segments"] = segs
        del xa
        torch.cuda.empty_cache()

    if "host" in parts:
        xa = ht.array(x, split=0, copy=False)
        mu, sd = ht.mean(xa, axis=0), ht.std(xa, axis=0)
        host = {}
        orig = lev.lazy_fused
        for b in (1, 256):
            rows_t = ht.array(torch.randn(b, F, device=dev, generator=gen))
            calls = []

            def rec(prog, inputs, shape, reduce=False, calls=calls):
                outs = orig(prog, inputs, shape, reduce)
                calls.append((prog, list(inputs), tuple(shape), reduce))
                return outs

            lev.lazy_fused = rec
            try:
                with ht.lazy():
                    r = (rows_t - mu) / sd
                r.larray
                torch.cuda.synchronize()
            finally:
                lev.lazy_fused = orig
            (prog, inputs, shape, reduce), = calls
            for _ in range(50):
                lazy_fused(prog, inputs, shape, reduce)
            torch.cuda.synchronize()
            us = []
            for i in range(400):
                t = time.perf_counter()
                lazy_fused(prog, inputs, shape, reduce)
                us.append((time.perf_counter() - t) * 1e6)
                if i % 50 == 49:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            host[b] = statistics.median(us)
            lfm = sys.modules["heat_tpu_torch.core.kernels.lazy_fused"]
            if hasattr(lfm, "_entry"):  # the launch's own share: the C call with the cached plan's arguments
                index, sms = lfm._device(dev)
                e = lfm._entry(prog, inputs, shape, reduce, sms)
                out = torch.empty(shape, dtype=prog.outputs[0][1], device=dev)
                ptrs = (lfm.ctypes.c_void_p * (len(inputs) + 1))(*[t.data_ptr() for t in inputs], out.data_ptr())
                lib, raw = lfm._library(), torch._C._cuda_getCurrentRawStream(index)
                cus = []
                for i in range(400):
                    t = time.perf_counter()
                    lib.lazy_fused(lfm.ctypes.byref(e.plan), ptrs, e.imm_array, lfm.ctypes.byref(e.red),
                                   int(e.reg64), e.grid, e.smem, None, None, 0, 0, index, raw)
                    cus.append((time.perf_counter() - t) * 1e6)
                    if i % 50 == 49:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                host[f"{b}_launch"] = statistics.median(cus)
                print(f"[probe {args.label}] host: of which the C call (launch) {host[f'{b}_launch']:.2f} us",
                      flush=True)
            print(f"[probe {args.label}] host: one warm lazy_fused call at a serve bucket of {b} rows "
                  f"({len(prog.instrs)} instructions, {len(inputs)} inputs): {host[b]:.2f} us (median of 400)",
                  flush=True)
        res["host_us"] = host
        del xa

    if "threefry" in parts:
        from heat_tpu_torch.core.kernels import threefry_bits
        from heat_tpu_torch.core.kernels.threefry import chunk_layout

        layout = chunk_layout((N, F), None, 0, 0)
        key = (0x12345678, 0x9ABCDEF0)
        tf = {}
        for kind, lo, dt in (("normal32", 0.0, torch.float32), ("uniform16", 0.0, torch.float16),
                             ("uniformbf16", 0.0, torch.bfloat16), ("normal16", -1 + 2.0 ** -11, torch.float16),
                             ("normalbf16", -1 + 2.0 ** -8, torch.bfloat16)):
            if kind == "normal32":
                lo_r, scale = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))), 2.0
            else:
                lo_r = float(torch.tensor(lo, dtype=dt))
                scale = float(torch.tensor(float(torch.tensor(1.0, dtype=dt)) - lo_r, dtype=dt))
            ms = time_ms(lambda: threefry_bits(key, layout, kind, dev, lo_r, scale))
            tf[kind] = ms
            print(f"[probe {args.label}] threefry_bits {kind} ({N}, {F}): {ms:.4f} ms", flush=True)
        res["threefry_ms"] = tf
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(card.split(",")[0] + "," + card.split(",")[1])
    print(json.dumps({k: v for k, v in res.items() if k not in ("ptxas", "sweep", "segments", "sass")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
