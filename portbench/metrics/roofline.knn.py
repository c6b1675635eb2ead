"""``roofline.knn``: the least time of a predict's counted work over the time
the card was busy inside the ``predict`` spans, in %: the whole predict's
share of the card's float32-accurate peak, whatever kernels carry it.

The count: 2 n m f flops for n queries against m training rows of f
features, against 165 TFLOP/s, the card's float32-accurate tensor-core rate
(495 TFLOP/s TF32 over three products; 67 TFLOP/s outside the tensor
cores), or the bytes (both operands read once, k distances and indices
written) against 3.35 TB/s, whichever is larger.
"""
from portbench import peaks


def bytes_flops(n: int, m: int, f: int, k: int):
    return (n + m) * f * 4 + n * k * 8, 2 * n * m * f


def bound_s(run) -> float:
    d = run.config["data"]
    n = int(d["test_events"])
    nbytes, flops = bytes_flops(n, int(d["events"]) - n, int(d["features"]), int(run.traffic["n_neighbors"]))
    return max(nbytes / peaks.HBM_BYTES_S, flops / peaks.FP32_ACCURATE_TC_FLOPS)


def read(run):
    if run.trace is None or not run.jobs:
        return None
    busy = run.trace.span_busy_us("predict")
    return bound_s(run) * run.jobs / (busy * 1e-6) * 100.0 if busy else None
