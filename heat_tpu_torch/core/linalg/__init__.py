"""Linear algebra (counterpart of ``heat_tpu.core.linalg``): ``matmul``,
``dot``, ``outer``, ``transpose``, ``tril``/``triu``, ``trace`` and the
norms; ``cholesky`` over the ``chol_panel_fused`` kernel (blocked across
ranks for a split operand, the kernel on each diagonal block),
``solve_triangular`` (blocked substitution across ranks), and ``qr``
(CholeskyQR2 with a Householder fallback)."""
from . import basics, factorizations
from .basics import *
from .factorizations import cholesky, solve_triangular
from .qr import qr
