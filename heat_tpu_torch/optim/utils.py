"""Optimizer utilities (counterpart of ``heat_tpu/optim/utils.py``; pure Python, this package's own copy)."""
from __future__ import annotations

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect whether a metric has stopped improving (reference
    ``optim/utils.py:14``).

    Parameters: ``mode`` ('min'/'max'), ``patience``, ``threshold``,
    ``threshold_mode`` ('rel'/'abs').
    """

    def __init__(
        self,
        mode: str = "min",
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.best = None
        self.num_bad_epochs = 0
        self.reset()

    def reset(self) -> None:
        """reference ``utils.py``"""
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.num_bad_epochs = 0

    def get_state(self) -> dict:
        """Checkpointable state (reference ``utils.py:72``)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def set_state(self, state: dict) -> None:
        """reference ``utils.py:108``"""
        for key, value in state.items():
            setattr(self, key, value)

    def is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def test_if_improving(self, metric: float) -> bool:
        """True if the metric has plateaued for ``patience`` steps
        (reference ``utils.py``)."""
        if self.is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return True
        return False
