"""On a card (the ``gpu`` marker; skips without one): the harness at a small
size with the kernels, and its control."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "knn_susy_predict": {"overrides": {"events": 600_000, "test_events": 100_000},
                         "traffic_overrides": {"compare_queries": 8_192}},
    "cdist_susy": {"overrides": {"events": 20_000}},
}
CODE = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
opts = json.loads({opts!r})
opts.update(t0=time.time(), device="cuda")
print(json.dumps(harness.run(opts)))
"""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("control", [0, 1])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_on_card(card, workload, control):
    opts = dict(SMALL[workload], workload=workload, seed=2**31 + 77, seconds=1.0, trace=0, control=control)
    code = CODE.format(root=str(ROOT), opts=json.dumps(opts))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["_found"] == []
    assert line["correct"] is (control == 0), line["compared"]
