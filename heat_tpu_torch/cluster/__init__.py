"""Clustering algorithms (counterpart of ``heat_tpu.cluster``)."""
from .kmeans import KMeans
