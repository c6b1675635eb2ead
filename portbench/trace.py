"""The device trace of a traced run, read from ``torch.profiler``'s export.

Times are the trace's microseconds, on the host's clock (the profiler maps
the card's timestamps onto it). Device operations are kernels, copies and
fills; spans are the ranges the benchmark opens (``portbench.<name>``).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: list):
        ops, spans, host = [], {}, []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            t0, t1 = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
            if cat in DEVICE_CATS:
                ops.append((t0, t1, name, cat))
            elif cat == "user_annotation" and name.startswith("portbench."):
                spans.setdefault(name[len("portbench."):], []).append((t0, t1))
                host.append((t0, t1, name))
            elif cat in HOST_CATS:
                host.append((t0, t1, name))
        ops.sort()
        self.ops, self.spans, self.host = ops, spans, host
        win = spans.get("window") or ([(ops[0][0], ops[-1][1])] if ops else [(0.0, 0.0)])
        self.lo, self.hi = win[0]
        self._merge()

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _merge(self):
        merged = []
        for t0, t1, _, _ in self.ops:
            if merged and t0 <= merged[-1][1]:
                if t1 > merged[-1][1]:
                    merged[-1][1] = t1
            else:
                merged.append([t0, t1])
        self.merged = merged
        self._starts = [m[0] for m in merged]

    def busy_us(self, lo: float, hi: float) -> float:
        """Microseconds of [lo, hi] in which some device operation ran."""
        total = 0.0
        i = max(0, bisect.bisect_right(self._starts, lo) - 1)
        while i < len(self.merged) and self.merged[i][0] < hi:
            a, b = max(self.merged[i][0], lo), min(self.merged[i][1], hi)
            if b > a:
                total += b - a
            i += 1
        return total

    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_s(self) -> float:
        return self.busy_us(self.lo, self.hi) * 1e-6

    def span_busy_us(self, name: str) -> float:
        """Device-busy microseconds inside every span ``name``."""
        return sum(self.busy_us(a, b) for a, b in self.spans.get(name, []))

    def kernels(self) -> list:
        """Kernels that started in the window."""
        return [op for op in self.ops if op[3] == "kernel" and self.lo <= op[0] <= self.hi]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps with the innermost host range running at each one's middle."""
        by_name = {}
        for t0, t1, name, _ in self.ops:
            if self.lo <= t0 <= self.hi:
                by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.lo
        for a, b in self.merged:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        if self.hi > prev:
            gaps.append((self.hi - prev, prev, self.hi))
        gaps = sorted(gaps, reverse=True)[:top]
        mids = [(g[1] + g[2]) / 2 for g in gaps]
        inner = [None] * len(mids)
        for h0, h1, name in self.host:
            if name == "portbench.window":
                continue
            for i, m in enumerate(mids):
                if h0 <= m <= h1 and (inner[i] is None or h1 - h0 < inner[i][0]):
                    inner[i] = (h1 - h0, name)
        idle = [[inner[i][1] if inner[i] else "host outside any range", g[0] * 1e-6] for i, g in enumerate(gaps)]
        return {"device_ops": [[n, us * 1e-6] for n, us in device_ops], "idle_gaps": idle}
