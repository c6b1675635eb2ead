"""Bundled datasets (counterpart of ``heat_tpu/datasets/``).

Small generated datasets whose exact ground truth is stored inside each
file (see :mod:`.generate`), and ``iris.csv``. The files here are this
package's own copies. Loaders return DNDarrays through the ordinary
parallel I/O path (:func:`heat_tpu_torch.core.io.load_hdf5`): a split load
reads only this rank's rows.
"""
from __future__ import annotations

import os
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))


def dataset_path(name: str) -> str:
    """Absolute path of a bundled dataset file (e.g. ``"blobs.h5"``)."""
    path = os.path.join(_HERE, name)
    if not os.path.exists(path):
        hint = (
            "it ships with the package and cannot be regenerated"
            if name.startswith("iris")
            else "run python -m heat_tpu_torch.datasets.generate"
        )
        raise FileNotFoundError(f"bundled dataset {name!r} not found; {hint}")
    return path


def load_blobs(split: Optional[int] = 0, device=None, comm=None):
    """(data, labels, centers): 4-cluster 2-D blobs with exact centers."""
    from ..core import io

    path = dataset_path("blobs.h5")
    return (
        io.load_hdf5(path, "data", split=split, device=device, comm=comm),
        io.load_hdf5(path, "labels", dtype="int64", split=split, device=device, comm=comm),
        io.load_hdf5(path, "centers", device=device, comm=comm),
    )


def load_classes(split: Optional[int] = 0, device=None, comm=None):
    """((train_x, train_y), (test_x, test_y)): 3-class gaussian data."""
    from ..core import io

    path = dataset_path("classes.h5")
    return (
        (
            io.load_hdf5(path, "train_x", split=split, device=device, comm=comm),
            io.load_hdf5(path, "train_y", dtype="int64", split=split, device=device, comm=comm),
        ),
        (
            io.load_hdf5(path, "test_x", split=split, device=device, comm=comm),
            io.load_hdf5(path, "test_y", dtype="int64", split=split, device=device, comm=comm),
        ),
    )


def load_regression(split: Optional[int] = 0, device=None, comm=None):
    """(x, y, coef): sparse linear regression with the true coefficients."""
    from ..core import io

    path = dataset_path("regression.h5")
    return (
        io.load_hdf5(path, "x", split=split, device=device, comm=comm),
        io.load_hdf5(path, "y", split=split, device=device, comm=comm),
        io.load_hdf5(path, "coef", device=device, comm=comm),
    )


__all__ = ["dataset_path", "load_blobs", "load_classes", "load_regression"]
