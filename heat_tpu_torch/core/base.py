"""sklearn-style estimator base classes (counterpart of ``heat_tpu/core/base.py``)."""
from __future__ import annotations

import inspect
from typing import Dict, List

__all__ = ["BaseEstimator", "ClusteringMixin", "is_clusterer", "is_estimator"]


class BaseEstimator:
    """Estimator base with sklearn-clone-compatible params handling."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind != p.VAR_KEYWORD and p.kind != p.VAR_POSITIONAL
        )

    def get_params(self, deep: bool = True) -> Dict:
        """Parameters of this estimator."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set parameters."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}")
            if delim:
                getattr(self, key).set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self, indent: int = 1) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{self.__class__.__name__}({params})"


class ClusteringMixin:
    """Mixin for clusterers."""

    _estimator_type = "clusterer"

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


def is_estimator(estimator) -> bool:
    return isinstance(estimator, BaseEstimator)


def is_clusterer(estimator) -> bool:
    return getattr(estimator, "_estimator_type", None) == "clusterer"
