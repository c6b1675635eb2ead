"""``roofline.cdist``: the least time of a distance matrix's counted work over
the time the card was busy inside the ``cdist`` spans, in %: the whole
call's share of the card's peak, whatever kernels carry it and in either
form.

The count, for an (n, f) operand against itself: the n x n float32 matrix
written once and the operand read once, against 3.35 TB/s; or 2 n n f flops
(the fewest of the two forms: the expansion's product) against 165 TFLOP/s,
the most a float32-accurate computation reaches on the card (3xTF32 on the
tensor cores); whichever is larger. The bytes bind.
"""
from portbench import peaks


def bytes_flops(n: int, f: int):
    return n * n * 4 + n * f * 4, 2 * n * n * f


def bound_s(run) -> float:
    d = run.config["data"]
    nbytes, flops = bytes_flops(int(d["events"]) - int(d["test_events"]), int(d["features"]))
    return max(nbytes / peaks.HBM_BYTES_S, flops / peaks.FP32_ACCURATE_TC_FLOPS)


def read(run):
    if run.trace is None or not run.jobs:
        return None
    busy = run.trace.span_busy_us("cdist")
    return bound_s(run) * run.jobs / (busy * 1e-6) * 100.0 if busy else None
