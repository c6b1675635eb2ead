"""Classification (counterpart of ``heat_tpu.classification``)."""
from .kneighborsclassifier import KNeighborsClassifier
