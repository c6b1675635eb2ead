"""Clustering algorithms (counterpart of ``heat_tpu.cluster``)."""
from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids
from .spectral import Spectral
from .streaming import StreamingKMeans
