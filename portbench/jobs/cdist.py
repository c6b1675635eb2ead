"""Job kind ``cdist``: the distance matrix of a data set with itself, as Heat's
distance-matrix benchmark computes it.

Set-up makes the configuration's events on the card and hands them to the
program, split 0. A job is ``ht.spatial.cdist(x, quadratic_expansion=q)``;
it ends when the card has finished the matrix. Every job does the same
work. Of each job's matrix the rows drawn from the seed (``compare_rows``
of them) are kept on the card, a copy of a few MB beside the matrix's GB.

The comparison re-makes the events from the seed and works out those rows
by differences in float64 (``reference/cdist.py``):

- ``dist_gap``: the largest |program - reference| over the kept rows of
  every job, over the median reference distance. A float32 computation
  reads about float32's rounding; a row left out or altered reads large.
"""
from __future__ import annotations

import torch

from portbench.reference import cdist as ref


def _rows(ctx, n: int, device) -> torch.Tensor:
    return torch.tensor(ctx.sample(n, int(ctx.traffic["compare_rows"])), device=device)


def setup(ctx) -> dict:
    x = ctx.make_data()["train_x"]
    return {"x": ctx.ht.array(x, is_split=0, copy=False), "rows": _rows(ctx, x.shape[0], x.device)}


def job(ctx, state: dict, j: int) -> dict:
    with ctx.span("cdist"):
        d = ctx.ht.spatial.cdist(state["x"], quadratic_expansion=bool(ctx.traffic["quadratic_expansion"]))
        kept = d.larray.index_select(0, state["rows"])
        ctx.sync()
    return {"rows": kept}


def setup_control(ctx) -> dict:
    """The reference in the control precision, in the program's place."""
    x = ctx.make_data()["train_x"]
    return {"x": x, "rows": _rows(ctx, x.shape[0], x.device)}


def job_control(ctx, state: dict, j: int) -> dict:
    with ctx.span("cdist"):
        d = ref.distances(state["x"], state["x"], "bfloat16")
        kept = d.index_select(0, state["rows"])
        ctx.sync()
    return {"rows": kept}


def compare(ctx, outputs: dict) -> dict:
    x = ctx.make_data()["train_x"]
    rows = _rows(ctx, x.shape[0], x.device)
    want = ref.distances(x[rows], x, "float64")
    scale = float(want.median())
    worst = 0.0
    for out in outputs.values():
        got = out["rows"]
        if tuple(got.shape) != tuple(want.shape):
            return {"dist_gap": float("inf")}
        gap = float((got.double() - want).abs().max()) / scale
        worst = float("inf") if gap != gap else max(worst, gap)
    return {"dist_gap": worst}
