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
from .statistics import *
from . import kernels
from . import random
