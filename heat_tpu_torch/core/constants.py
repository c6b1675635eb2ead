"""Mathematical constants (reference ``heat/core/constants.py``)."""
import numpy as np

__all__ = [
    "e",
    "Euler",
    "inf",
    "Inf",
    "Infty",
    "Infinity",
    "nan",
    "NaN",
    "pi",
    "PI",
    "E",
    "INF",
    "NINF",
    "NAN",
]

e = float(np.e)
pi = float(np.pi)
inf = float("inf")
nan = float("nan")

# aliases (reference ``constants.py``)
Euler = e
Inf = inf
Infty = inf
Infinity = inf
NaN = nan

# uppercase source names (reference ``constants.py:10-18``)
PI = pi
E = e
INF = inf
NINF = -inf
NAN = nan
