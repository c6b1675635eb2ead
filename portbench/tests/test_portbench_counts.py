"""The operation and byte counts behind the roofline, against hand counts,
and the trace's reading of busy time."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, peaks  # noqa: E402


def test_peaks():
    assert peaks.HBM_BYTES_S == 3.35e12 and peaks.FP32_FLOPS == 67e12
    assert peaks.FP32_ACCURATE_TC_FLOPS == pytest.approx(165e12)


def test_knn_counts_by_hand():
    m = harness.load_named("metrics", "roofline.knn")
    # 2 queries, 3 rows, 4 features, k = 1: (2 + 3) x 4 x 4 + 2 x 1 x 8 B; 2 x 2 x 3 x 4 flops
    assert m.bytes_flops(2, 3, 4, 1) == (96, 48)
    run = type("Run", (), {"config": {"data": {"events": 5_000_000, "test_events": 500_000, "features": 18}},
                           "traffic": {"n_neighbors": 5}})()
    assert m.bound_s(run) == pytest.approx(2 * 500_000 * 4_500_000 * 18 / 165e12)  # flops bind: 491 ms
    assert m.bound_s(run) == pytest.approx(0.490909, rel=1e-5)


def test_cdist_counts_by_hand():
    m = harness.load_named("metrics", "roofline.cdist")
    # 3 rows of 2 features: 3 x 3 x 4 + 3 x 2 x 4 B; 2 x 3 x 3 x 2 flops
    assert m.bytes_flops(3, 2) == (60, 36)
    run = type("Run", (), {"config": {"data": {"events": 40_000, "test_events": 0, "features": 18}}})()
    assert m.bound_s(run) == pytest.approx((40_000**2 * 4 + 40_000 * 18 * 4) / 3.35e12)  # bytes bind: 1.9 ms
    assert m.bound_s(run) == pytest.approx(0.0019113, rel=1e-4)


def test_trace_busy_union():
    from portbench.trace import Trace

    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.predict", "ts": 10, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "knn_partial", "ts": 5, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "row_norms", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30}]
    t = Trace(ev)
    assert t.busy_us(0, 100) == 45 and t.span_busy_us("predict") == 30
    assert t.window_s() == pytest.approx(1e-4) and len(t.kernels()) == 2
    b = t.breakdown()
    assert b["device_ops"][0] == ["knn_partial", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(30e-6)]
