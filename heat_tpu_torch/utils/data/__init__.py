"""Data tooling (counterpart of ``heat_tpu/utils/data/``)."""
from . import _utils, datatools, matrixgallery, mnist, partial_dataset
from ._utils import (
    decode_image_bytes,
    encode_image_bytes,
    merge_shards_to_hdf5,
    tfrecord_index,
    write_tfrecord_indexes,
)
from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .mnist import MNISTDataset
from .partial_dataset import PartialH5DataLoaderIter, PartialH5Dataset
