"""heat_tpu_torch — heat_tpu ported to PyTorch and CUDA.

The distributed ``DNDarray`` and its analytics, written over torch tensors,
with hand-written CUDA kernels for Hopper where ``heat_tpu`` has Pallas TPU
kernels. Arrays live on the first CUDA card unless the caller asks for the
CPU (``use_device("cpu")`` or ``device="cpu"``). This package imports
nothing of JAX or of ``heat_tpu``.

This slice covers the main path: factories and arithmetic, ``mean``/
``var``/``std`` over the ``moments_onepass`` kernel, ``cdist`` and
``KMeans`` over the ``lloyd_fused`` kernel, on one card.
"""
from .core import *
from .core import kernels, random
from . import cluster, convert, spatial
from .core.kernels import KERNEL_STATS, LAUNCHES
