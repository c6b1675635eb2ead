"""Naive Bayes (counterpart of ``heat_tpu/naive_bayes/``)."""
from .gaussianNB import GaussianNB
