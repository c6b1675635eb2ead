"""Regression (counterpart of ``heat_tpu/regression/``)."""
from . import lasso
from .lasso import Lasso
