"""heat_tpu_torch core: the array API over PyTorch (counterpart of ``heat_tpu.core``)."""
from . import communication, devices, types
from .communication import *
from .devices import *
from .types import *
from .dndarray import *
from .factories import *
from .constants import *
from .stride_tricks import *
from .sanitation import *
from .arithmetics import *
from .exponential import *
from .indexing import *
from .logical import *
from .memory import *
from .relational import *
from .rounding import *
from .statistics import *
from .manipulations import *
from .trigonometrics import *
from . import (
    arithmetics, exponential, indexing, logical, manipulations, memory, relational, rounding, statistics,
    trigonometrics,
)
from . import linalg
from . import lazy as _lazy_pkg  # installs the dispatchers' capture hook
from .lazy import FUSE_STATS, LazyDNDarray, fuse, lazy, reset_fuse_stats
from .linalg.basics import *
from . import kernels
from . import random
from .random import *
from . import tiling
from .tiling import *
from .base import *
from . import complex_math, io, printing, signal, version
from .complex_math import *
from .io import *
from .printing import *
from .signal import *
from .version import __version__
