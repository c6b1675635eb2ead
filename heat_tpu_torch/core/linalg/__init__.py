"""Linear algebra (counterpart of ``heat_tpu.core.linalg``): ``matmul``,
``dot``, ``vdot``/``vecdot``, ``outer``, ``cross``, ``projection``,
``transpose``, ``tril``/``triu``, ``trace`` and the norms; ``cholesky``
over the ``chol_panel_fused`` kernel (blocked across ranks for a split
operand, the kernel on each diagonal block), ``solve_triangular`` (blocked
substitution across ranks), LU with partial pivoting behind ``solve``,
``det`` and ``inv`` (blocked across ranks), ``qr`` (CholeskyQR2 with a
Householder fallback; TSQR across ranks), the iterative ``cg`` and
``lanczos``, and ``svd``/``rsvd``/``lstsq``/``pinv``."""
from . import basics, factorizations, solver, svd
from .basics import *
from .factorizations import cholesky, solve, solve_triangular
from .qr import qr
from .solver import *
from .svd import lstsq, pinv, rsvd, svd
