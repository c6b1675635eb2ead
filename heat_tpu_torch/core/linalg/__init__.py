"""Linear algebra (counterpart of ``heat_tpu.core.linalg``): ``matmul`` and
``transpose``, ``cholesky`` over the ``chol_panel_fused`` kernel, and
``solve_triangular``."""
from . import basics, factorizations
from .basics import *
from .factorizations import cholesky, solve_triangular
