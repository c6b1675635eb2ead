"""MNIST dataset (counterpart of ``heat_tpu/utils/data/mnist.py``).

Heat subclasses ``torchvision.datasets.MNIST``; torchvision is not a
dependency here, so the raw IDX files (plain or gzipped) are read
directly. The images become a float32 DNDarray in [0, 1] of shape
(n, 28, 28), the labels an int64 DNDarray, both split along 0 as asked.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ...core import factories
from ...core.dndarray import DNDarray

__all__ = ["MNISTDataset"]

# the IDX type codes and their big-endian numpy types
_IDX_TYPES = {0x08: ">u1", 0x09: ">i1", 0x0B: ">i2", 0x0C: ">i4", 0x0D: ">f4", 0x0E: ">f8"}


def _read_idx(path: str) -> np.ndarray:
    """An IDX file (``.gz`` or plain) as a numpy array of its shape and type."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code not in _IDX_TYPES:
            raise ValueError(f"{path} is not an IDX file (magic {zero:#06x}, type {dtype_code:#04x})")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=_IDX_TYPES[dtype_code])
    if data.size != int(np.prod(shape)):
        raise ValueError(f"{path}: {data.size} values for the shape {shape}")
    return data.astype(data.dtype.newbyteorder("="), copy=False).reshape(shape)


class MNISTDataset:
    """MNIST over DNDarrays.

    Parameters
    ----------
    root : str
        Directory holding the raw IDX files (train-images-idx3-ubyte[.gz] etc.).
    train : bool
    transform, target_transform : callable, optional
        Applied to an image / a label on indexing.
    split : int or None
        Split of the sample axis (Heat splits 0).
    """

    _FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str, train: bool = True, transform=None, target_transform=None,
                 split: Optional[int] = 0, device=None, comm=None):
        img_name, lbl_name = self._FILES[train]
        images = labels = None
        for suffix in ("", ".gz"):
            ipath = os.path.join(root, img_name + suffix)
            lpath = os.path.join(root, lbl_name + suffix)
            if os.path.exists(ipath) and os.path.exists(lpath):
                images = _read_idx(ipath)
                labels = _read_idx(lpath)
                break
        if images is None:
            raise FileNotFoundError(f"MNIST idx files not found under {root}")
        self.transform = transform
        self.target_transform = target_transform
        imgs = images.astype(np.float32) / 255.0
        self.htdata = factories.array(imgs, split=split, device=device, comm=comm)
        self.httargets = factories.array(labels.astype(np.int64), split=split, device=device, comm=comm)

    @property
    def data(self) -> DNDarray:
        return self.htdata

    @property
    def targets(self) -> DNDarray:
        return self.httargets

    def __len__(self) -> int:
        return self.htdata.shape[0]

    def __getitem__(self, index):
        """(image, label) of this rank's local row ``index``, transformed."""
        img = self.htdata.larray[index]
        target = self.httargets.larray[index]
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target
