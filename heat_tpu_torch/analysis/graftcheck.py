"""graftcheck — the port's static-analysis gate: graftlint (G001–G007) and
graftflow (F001–F009, DRIFT) over one set of paths, one report.

Usage::

    python -m heat_tpu_torch.analysis.graftcheck heat_tpu_torch/ [--format text|json] [--select G004,F001]
    python tools/torch_graftcheck.py heat_tpu_torch/            # the same, without importing torch

Exit code is a bitmask: 1 graftlint findings, 2 graftflow findings, 4
summary drift (DRIFT), 128 a syntax or internal error. Both analyzers are
pure stdlib; they are loaded from their files here, so a run never
imports ``torch``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import List, Optional, Set

__all__ = ["load_analyzers", "run_check", "main"]

DEFAULT_PATHS = ["heat_tpu_torch"]


def _load(modname: str, filename: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), filename)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve cls.__module__ through sys.modules
    spec.loader.exec_module(mod)
    return mod


def load_analyzers():
    """(graftlint, graftflow) loaded by file path."""
    lint = sys.modules.get("_torch_graftlint") or _load("_torch_graftlint", "graftlint.py")
    flow = sys.modules.get("_torch_graftflow") or _load("_torch_graftflow", "graftflow.py")
    return lint, flow


def run_check(paths: List[str], select: Optional[Set[str]] = None) -> dict:
    """Both analyzers over ``paths``; the merged report (findings as dicts,
    counts per rule, files checked, the exit bitmask)."""
    lint, flow = load_analyzers()
    lsel = None if select is None else {s for s in select if s in lint.RULES}
    fsel = None if select is None else {s for s in select if s not in lint.RULES}
    lf, ln = lint.lint_paths(paths, select=lsel) if lsel != set() else ([], 0)
    ff, fn = flow.analyze_paths(paths, select=fsel) if fsel != set() else ([], 0)
    findings = [f.as_dict() for f in lf] + [f.as_dict() for f in ff]
    counts = {}
    for f in findings:
        counts[f["rule"]] = counts.get(f["rule"], 0) + 1
    code = 0
    for rule in counts:
        if rule == "SYNTAX":
            code |= 128
        elif rule == "DRIFT":
            code |= 4
        elif rule.startswith("G"):
            code |= 1
        elif rule.startswith("F"):
            code |= 2
    return {"paths": list(paths), "files_checked": max(ln, fn), "findings": findings, "counts": counts,
            "exit_code": code}


def render_text(report: dict) -> str:
    lines = [f"{f['path']}:{f['line']}:{f['col']}: {f['rule']} {f['message']}" for f in report["findings"]]
    lines.append(f"graftcheck: {len(report['findings'])} finding(s) in {report['files_checked']} file(s)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="graftcheck", description="the port's SPMD static-analysis gate")
    parser.add_argument("paths", nargs="*", default=None, help=f"files/dirs (default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--select", default=None, help="comma-separated rule ids (G004,F001,DRIFT,...)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)
    lint, flow = load_analyzers()
    if args.list_rules:
        for r in lint.RULES.values():
            print(f"graftlint {r.id} {r.tag}: {r.summary}")
        for r in list(flow.RULES.values()) + [flow.DRIFT_RULE]:
            print(f"graftflow {r.id} {r.tag}: {r.summary}")
        return 0
    select = None if not args.select else {s.strip() for s in args.select.split(",") if s.strip()}
    report = run_check(args.paths or DEFAULT_PATHS, select=select)
    print(json.dumps(report, sort_keys=True) if args.format == "json" else render_text(report))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
