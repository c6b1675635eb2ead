"""Spatial distance functions (counterpart of ``heat_tpu.spatial``)."""
from . import distance
from .distance import cdist, nearest_neighbors, rbf
