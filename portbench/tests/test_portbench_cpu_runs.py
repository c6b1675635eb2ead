"""Runs of the harness on the CPU at a small size, each in a process of its
own (``cpu_run``): the program agrees with the reference; the control (the
reference in TF32, in the program's place) and each fault planted in the
program come out not correct; the result line has the contract's keys."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242
SMALL = {
    "knn_susy_predict": {"overrides": {"events": 60_000, "test_events": 5_000},
                         "traffic_overrides": {"compare_queries": 2_000}},
    "cdist_susy": {"overrides": {"events": 3_000}},
}
SPAN = {"knn_susy_predict": "predict_ms", "cdist_susy": "cdist_ms"}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def run(workload: str, seconds: float = 0.5, trace: int = 0, **extra) -> dict:
    opts = dict(SMALL[workload], workload=workload, seed=SEED, seconds=seconds, trace=trace, **extra)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "portbench.tests.cpu_run", json.dumps(opts)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_program_agrees_with_the_reference(workload):
    line = run(workload)
    assert set(line) == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0, line
    assert set(line["metrics"]) == {"job_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["count"] == 1


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_line(workload):
    line = run(workload, trace=1)
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "compared"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) == {SPAN[workload]}  # the trace's other metrics read device operations: none on the CPU


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    assert run(workload, control=1)["correct"] is False


@pytest.mark.parametrize("workload,fault", [
    ("knn_susy_predict", "knn_half_queries"),
    ("knn_susy_predict", "knn_half_train"),
    ("knn_susy_predict", "knn_answer_altered"),
    ("cdist_susy", "cdist_half_rows"),
    ("cdist_susy", "cdist_answer_altered"),
])
def test_fault_is_not_correct(workload, fault):
    line = run(workload, fault=fault)
    assert line["correct"] is False, line["compared"]
