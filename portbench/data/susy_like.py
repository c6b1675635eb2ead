"""Events shaped as the UCI SUSY data set (Baldi, Sadowski and Whiteson, 2014):
``events`` rows of ``features`` float32 features and a 0/1 label, the last
``test_events`` rows the test set. Nothing is downloaded: the two classes
are Gaussians with unit covariance whose means lie ``separation`` apart
along a direction drawn from the seed (a Bayes accuracy of Phi(separation /
2), 0.76 at 1.4, near what published classifiers reach on SUSY), a share
``signal_share`` of the rows signal, and every feature given a scale and an
offset of its own, as raw physical features have, so that standardizing
matters.
"""
from __future__ import annotations

import math

import torch


def make(spec: dict, gen, device) -> dict:
    n, f, n_test = int(spec["events"]), int(spec["features"]), int(spec["test_events"])
    g = gen(0)
    direction = torch.randn(f, generator=g, device=device)
    shift = direction / torch.linalg.vector_norm(direction) * float(spec["separation"])
    lo, hi = math.log(spec["scale_range"][0]), math.log(spec["scale_range"][1])
    scale = torch.exp(torch.rand(f, generator=g, device=device) * (hi - lo) + lo)
    offset = torch.randn(f, generator=g, device=device) * float(spec["offset_scale"])
    y = (torch.rand(n, generator=g, device=device) < float(spec["signal_share"])).to(torch.int64)
    x = torch.randn((n, f), generator=g, device=device)
    x += y[:, None].to(x.dtype) * shift
    x.mul_(scale).add_(offset)
    n_train = n - n_test
    return {"train_x": x[:n_train], "train_y": y[:n_train], "test_x": x[n_train:]}
