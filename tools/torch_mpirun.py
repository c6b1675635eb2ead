"""CLI for the port's fault-tolerant multi-process suite runner
(``heat_tpu_torch.testing``), beside ``tools/mpirun.py``::

    python tools/torch_mpirun.py -n 2 -- tests/test_torch_surface.py   # one module at ws=2, gloo
    python tools/torch_mpirun.py -n 4 --sample 40 -- tests/test_torch_linalg.py
    python tools/torch_mpirun.py -n 4 --device cuda -- tests/...       # NCCL, one card per rank

Everything after ``--`` goes to the workers' pytest. Results stream to
stdout as they arrive (one character or line per test, RESTART events when
a group is recycled), and the last line is one JSON summary. ``--record
KEY`` stores the run under ``torch_ws_runs.KEY`` in ``SUITE_SECONDS.json``;
``--budget-check KEY`` fails (exit 3) when the wall clock exceeds that
baseline by more than ``--budget-tolerance``.

The package is loaded by file path, so the coordinator never imports torch.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# regression tolerance for --budget-check: a ws run slower than
# baseline * (1 + tolerance) fails the gate
DEFAULT_BUDGET_TOLERANCE = 0.20


def _load_testing():
    """Load ``heat_tpu_torch.testing`` directly from its files, without
    running ``heat_tpu_torch/__init__`` (which imports torch).

    Registering the package in ``sys.modules`` first makes its internal
    relative imports resolve against that entry — but ``__import__`` then
    still returns the TOPMOST package (``_gcd_import(name.partition('.')[0])``),
    which would import the real package. A throwaway stub parent with
    an empty ``__path__`` absorbs that lookup (and makes any accidental
    ``heat_tpu_torch.<anything-else>`` import fail loudly instead of silently
    booting a backend); it is removed afterwards so a later genuine
    ``import heat_tpu_torch`` in the same process still works."""
    pkg_dir = os.path.join(REPO_ROOT, "heat_tpu_torch", "testing")
    name = "heat_tpu_torch.testing"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    stub = None
    if "heat_tpu_torch" not in sys.modules:
        import types

        stub = types.ModuleType("heat_tpu_torch")
        stub.__path__ = []
        stub.testing = mod
        sys.modules["heat_tpu_torch"] = stub
    try:
        spec.loader.exec_module(mod)
    finally:
        if stub is not None and sys.modules.get("heat_tpu_torch") is stub:
            del sys.modules["heat_tpu_torch"]
    return mod


# --------------------------------------------------------------- budget gate
def load_suite_seconds(path=None) -> dict:
    path = path or os.path.join(REPO_ROOT, "SUITE_SECONDS.json")
    try:
        with open(path, "r") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def record_ws_run(key: str, summary: dict, path=None) -> None:
    """Merge this run into ``SUITE_SECONDS.json`` under ``torch_ws_runs.KEY``,
    preserving the tier-1 keys the conftest writer owns."""
    path = path or os.path.join(REPO_ROOT, "SUITE_SECONDS.json")
    data = load_suite_seconds(path)
    runs = data.setdefault("torch_ws_runs", {})
    runs[key] = {
        "suite_seconds": summary["wall_seconds"],
        "world_size": summary["world_size"],
        "collected": summary["collected"],
        "counts": summary["counts"],
        "restarts": summary["restarts"],
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")


def check_budget(key: str, wall_seconds: float, data: dict,
                 tolerance: float = DEFAULT_BUDGET_TOLERANCE):
    """Return a list of violation strings (empty = within budget).

    A missing baseline passes — the FIRST recorded run establishes it;
    after that, >``tolerance`` wall-clock growth is a named failure, the
    same creep discipline ``tools/bench_check.py`` applies to kernel
    latencies."""
    baseline = (data.get("torch_ws_runs") or {}).get(key, {}).get("suite_seconds")
    if baseline is None:
        return []
    limit = float(baseline) * (1.0 + tolerance)
    if float(wall_seconds) > limit:
        return [
            f"ws run '{key}' took {wall_seconds:.1f}s — over budget "
            f"(baseline {baseline:.1f}s + {tolerance:.0%} = {limit:.1f}s)"
        ]
    return []


# ----------------------------------------------------------------- reporting
_GLYPH = {
    "passed": ".", "skipped": "s", "quarantined": "q",
    "failed": "F", "error": "E", "restart-failure": "R", "uneven": "U",
}


def _print_event(rec: dict, verbose: bool) -> None:
    kind = rec.get("kind")
    if kind == "restart":
        print(f"RESTART group={rec['group']} #{rec['restart']} "
              f"in_flight={rec['in_flight'] or '-'} reason={rec['reason']}",
              flush=True)
        return
    if kind != "result":
        return
    outcome = rec["outcome"]
    if verbose or outcome not in ("passed", "skipped"):
        line = f"{outcome.upper():<16} {rec['id']} ({rec['duration']:.2f}s)"
        if outcome not in ("passed", "skipped", "quarantined") and rec.get("exc_type"):
            line += f" [{rec['exc_type']}]"
        print(line, flush=True)
    else:
        print(_GLYPH.get(outcome, "?"), end="", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="torch_mpirun.py", description="run the suite in real multi-process groups")
    parser.add_argument("-n", "--np", dest="world_size", type=int, default=2,
                        help="processes per worker group (world size)")
    parser.add_argument("--groups", type=int, default=1,
                        help="parallel worker groups (each of size -n)")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                        help="cpu: gloo ranks; cuda: NCCL, one card per rank")
    parser.add_argument("--deadline", type=float, default=120.0,
                        help="per-test wall-clock deadline (seconds)")
    parser.add_argument("--sample", type=int, default=None,
                        help="run a deterministic N-test shard instead of all")
    parser.add_argument("--seed", type=int, default=0,
                        help="shard selection seed for --sample")
    parser.add_argument("--max-restarts", type=int, default=5,
                        help="worker-group restarts before giving up")
    parser.add_argument("--quarantine", default=None,
                        help="quarantine file (default tests/ws_quarantine.txt)")
    parser.add_argument("--log-dir", default=None,
                        help="keep worker logs here (temp dir otherwise)")
    parser.add_argument("--record", metavar="KEY", default=None,
                        help="store this run under torch_ws_runs.KEY in SUITE_SECONDS.json")
    parser.add_argument("--budget-check", metavar="KEY", default=None,
                        help="fail (exit 3) if wall clock regresses >tolerance "
                             "over the recorded torch_ws_runs.KEY baseline")
    parser.add_argument("--budget-tolerance", type=float,
                        default=DEFAULT_BUDGET_TOLERANCE)
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="one line per test instead of dots")
    parser.add_argument("pytest_args", nargs="*",
                        help="pytest arguments after -- (default: -m 'not slow' tests)")
    args = parser.parse_args(argv)

    testing = _load_testing()
    cfg = testing.RunnerConfig(
        world_size=args.world_size,
        n_groups=args.groups,
        device=args.device,
        deadline=args.deadline,
        max_restarts=args.max_restarts,
        repo_root=REPO_ROOT,
        quarantine_path=args.quarantine,
        sample=args.sample,
        sample_seed=args.seed,
        log_dir=args.log_dir,
    )
    if args.pytest_args:
        cfg.pytest_args = list(args.pytest_args)

    runner = testing.SuiteRunner(cfg, on_event=lambda r: _print_event(r, args.verbose))
    try:
        result = runner.run()
    except testing.RunnerError as e:
        print(f"\nrunner error: {e}", file=sys.stderr, flush=True)
        return 2

    counts = result.counts()
    summary = {
        "world_size": result.world_size,
        "collected": result.collected,
        "counts": counts,
        "restarts": result.restarts,
        "wall_seconds": result.wall_seconds,
        "ok": result.ok,
    }
    # failures first so the tail of a long run is the interesting part
    bad = [r for r in result.results.values()
           if r["outcome"] in ("failed", "error", "restart-failure", "uneven")]
    if bad:
        print(f"\n--- {len(bad)} failing tests ---")
        for rec in sorted(bad, key=lambda r: r["id"]):
            head = (rec["error"] or "").strip().splitlines()
            print(f"  {rec['outcome']:<16} {rec['id']} "
                  f"[{rec.get('exc_type') or '?'}] {head[-1] if head else ''}")
    print()
    print(json.dumps(summary, sort_keys=True), flush=True)

    rc = 0 if result.ok else 1
    if args.record:
        record_ws_run(args.record, summary)
    if args.budget_check:
        violations = check_budget(args.budget_check, result.wall_seconds,
                                  load_suite_seconds(), args.budget_tolerance)
        for v in violations:
            print(f"BUDGET: {v}", file=sys.stderr, flush=True)
        if violations:
            rc = 3
    return rc


if __name__ == "__main__":
    sys.exit(main())
