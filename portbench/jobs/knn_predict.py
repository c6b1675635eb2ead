"""Job kind ``knn_predict``: the test set classified by k nearest neighbours.

Set-up makes the configuration's events on the card, hands the training
events and their labels to the program, standardizes the training events
there and fits a ``KNeighborsClassifier(n_neighbors)``. A job standardizes
the whole test set with the training moments, calls ``predict`` once over
it and ends when the labels are on the host. Every job does the same work.

The comparison re-makes the events from the seed, standardizes them itself
in float64 and classifies ``compare_queries`` test events drawn from the
seed by the exact vote (``reference/knn_predict.py``); every job of the
window is judged at those events:

- ``vote_margin``: the largest reference margin among the events whose
  label differs from the reference's (0 where none does). A label can
  differ only where the program's distances are off by the event's margin,
  so a float32-accurate program reads about float32's rounding here; a
  wrong label on an event with a clear margin, or a missing one, reads large.
"""
from __future__ import annotations

import torch

from portbench.reference import knn_predict as ref
from portbench.reference import precision as P


def setup(ctx) -> dict:
    ht = ctx.ht
    data = ctx.make_data()
    tx = ht.array(data["train_x"], copy=False)
    ty = ht.array(data["train_y"], copy=False)
    mu, sd = ht.mean(tx, axis=0), ht.std(tx, axis=0)
    zt = (tx - mu) / sd
    del tx
    clf = ht.classification.KNeighborsClassifier(n_neighbors=int(ctx.traffic["n_neighbors"])).fit(zt, ty)
    return {"clf": clf, "mu": mu, "sd": sd, "test": ht.array(data["test_x"], copy=False)}


def job(ctx, state: dict, j: int) -> dict:
    zq = (state["test"] - state["mu"]) / state["sd"]
    with ctx.span("predict"):
        labels = state["clf"].predict(zq).larray.cpu()
    return {"labels": labels}


def _standardized(data: dict, precision: str):
    """The training and test events standardized by the training moments, in ``precision``'s type."""
    t, mean, std = P.standardize(data["train_x"], precision)
    q = ((data["test_x"].double() - mean) / std).to(t.dtype)
    return t, q


def setup_control(ctx) -> dict:
    """The reference in the control precision, in the program's place."""
    data = ctx.make_data()
    t, q = _standardized(data, "tf32")
    return {"t": t, "labels": data["train_y"], "q": q}


def job_control(ctx, state: dict, j: int) -> dict:
    with ctx.span("predict"):
        labels, _ = ref.predict(state["q"], state["t"], state["labels"], int(ctx.traffic["n_neighbors"]), "tf32")
        labels = labels.cpu()
    return {"labels": labels}


def compare(ctx, outputs: dict) -> dict:
    data = ctx.make_data()
    t, q = _standardized(data, "float64")
    rows = torch.tensor(ctx.sample(q.shape[0], int(ctx.traffic["compare_queries"])), device=q.device)
    labels, margins = ref.predict(q[rows], t, data["train_y"], int(ctx.traffic["n_neighbors"]), "float64")
    labels, margins, rows = labels.cpu(), margins.cpu(), rows.cpu()
    worst = 0.0
    for got in outputs.values():
        got = got["labels"]
        if tuple(got.shape) != (q.shape[0],):
            return {"vote_margin": float("inf")}
        wrong = got[rows] != labels
        if bool(wrong.any()):
            worst = max(worst, float(margins[wrong].max()))
    return {"vote_margin": worst}
