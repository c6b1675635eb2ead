"""The engine of the port's benchmark: one cell, run once on one card.

Everything that belongs to one cell is found by name (``BENCHMARK.json``
names the cell, its configuration and its traffic mix):

- ``configs/<config>.json``: the deployment (its data generator and sizes);
- ``traffic/<mix>.json``: the mix, parameters only, naming the job kind;
- ``jobs/<job>.py``: set-up, one job and the comparison of a job kind;
- ``data/<generator>.py``: the generator of a configuration's data;
- ``metrics/<metric>.py``: the reader of one metric;
- ``limits/<workload>.json``: the limit of each number the cell compares.

A run sets up (data from the seed on the card, the program's state, warm
jobs), then runs jobs back to back for ``seconds`` (a closed loop of one
client: the next job starts when the last has returned its answer to the
host), reads the metrics, frees the program's state, and compares a sample
of the answers with the plain reference in ``reference/``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "heat_tpu")  # top-level module names, compared whole


def load_named(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r}: {path.relative_to(ROOT)} is missing")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r}: {path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, spec: dict, workload: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise LookupError(f"BENCHMARK.json has no workload {workload!r} (has {sorted(cells)})")
        self.name = workload
        self.entry = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((ROOT / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = load_json("traffic", self.entry["traffic"])
        self.limits = load_json("limits", workload)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)
        ]


class Context:
    """What a job kind sees of the run."""

    def __init__(self, cell: Cell, seed: int, device, ht, tracing: bool):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.ht, self.tracing = int(seed), device, ht, tracing
        self.spans = {}  # span name -> host seconds of each span in the window
        self.recording = False

    def generator(self, stream: int):
        """A torch generator on the card for one stream of this seed's data."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % 2**63)
        return g

    def make_data(self) -> dict:
        spec = self.config["data"]
        return load_named("data", spec["generator"]).make(spec, self.generator, self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around a call into the program: host seconds, and a range
        in the device trace of a traced run."""
        import torch

        rf = torch.profiler.record_function(f"portbench.{name}") if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        if self.recording:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def sample(self, n: int, count: int) -> list:
        """``count`` of ``range(n)`` drawn from the seed, sorted."""
        return sorted(random.Random(self.seed).sample(range(n), min(n, count)))

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Record:
    """What the metric readers read: the window, its spans and its trace."""

    def __init__(self, cell, jobs, job_seconds, window_s, setup_s, spans, trace):
        self.config, self.traffic = cell.config, cell.traffic
        self.jobs, self.job_seconds, self.window_s, self.setup_s = jobs, job_seconds, window_s, setup_s
        self.spans, self.trace = spans, trace


def _read_metrics(entries, record) -> dict:
    out = {}
    for m in entries:
        value = load_named("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _apply_fault(opts):
    """A fault planted in the program for a test of the comparison (tests only)."""
    if opts.get("fault"):
        spec = importlib.util.spec_from_file_location("portbench_faults", opts["fault_module"])
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.apply(opts["fault"])


def run(opts: dict) -> dict:
    """Run the cell ``opts["workload"]`` once; returns its result line (a
    dict). ``opts``: workload, seed, seconds, trace, t0 (the process start,
    time.time()), device ("cuda" or "cpu"), control (run the reference in
    the control precision in the program's place), and, for the tests,
    overrides (config data keys), traffic_overrides and fault /
    fault_module."""
    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(spec, opts["workload"])
    cell.config["data"].update(opts.get("overrides") or {})
    cell.traffic.update(opts.get("traffic_overrides") or {})
    device = torch.device("cuda", 0) if opts["device"] == "cuda" else torch.device("cpu")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    _apply_fault(opts)
    import heat_tpu_torch as ht

    ht.use_device("gpu" if on_card else "cpu")
    tracing = bool(opts["trace"])
    ctx = Context(cell, opts["seed"], device, ht, tracing)
    job = load_named("jobs", cell.traffic["job"])
    control = bool(opts.get("control"))
    state = job.setup_control(ctx) if control else job.setup(ctx)
    run_job = job.job_control if control else job.job
    for w in range(int(cell.traffic["warmup_jobs"])):
        run_job(ctx, state, -1 - w)
    ctx.sync()

    prof = _profiler(on_card) if tracing else None
    outputs, job_seconds = {}, []
    seconds = float(opts["seconds"])
    ctx.recording = True
    setup_s = time.time() - opts["t0"]
    if prof is not None:
        prof.__enter__()
    with (torch.profiler.record_function("portbench.window") if tracing else contextlib.nullcontext()):
        w0 = time.perf_counter()
        j = 0
        while True:
            s = time.perf_counter()
            outputs[j] = run_job(ctx, state, j)
            e = time.perf_counter()
            job_seconds.append(e - s)
            j += 1
            if e - w0 >= seconds:
                break
        window_s = e - w0
    ctx.recording = False
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from portbench.trace import Trace

        trace = Trace.from_profiler(prof)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    record = Record(cell, len(job_seconds), job_seconds, window_s, setup_s, ctx.spans, trace)
    metrics = _read_metrics(cell.per_layer if tracing else cell.end_to_end, record)
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        dev.update(busy_s=trace.busy_s(), window_s=trace.window_s())
    breakdown = trace.breakdown() if trace is not None else None
    found = forbidden_modules()
    del state, prof, trace, record
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    got = job.compare(ctx, outputs)
    compared = {name: {"value": got[name], "limit": cell.limits[name]["limit"]} for name in got}
    correct = set(compared) == set(cell.limits) and all(v["value"] <= v["limit"] for v in compared.values())
    line = {"correct": bool(correct), "attempted": len(job_seconds), "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = compared
    line["_found"] = sorted(set(found) | set(forbidden_modules()))
    return line


def _profiler(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)
