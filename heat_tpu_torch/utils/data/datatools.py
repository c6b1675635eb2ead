"""Dataset / DataLoader tooling (counterpart of ``heat_tpu/utils/data/datatools.py``).

A :class:`Dataset` holds DNDarrays whose axis 0 is the sample axis. An
item or a batch is taken by global index, as in ``heat_tpu``: a batch is
the rows ``[b * batch_size, (b + 1) * batch_size)`` of the (shuffled)
global arrays, split along 0 when the arrays are, so that each rank holds
its share of every batch. The epoch-end shuffle permutes the global rows
by a permutation drawn from the random stream (``heat_tpu``'s threefry
permutation, so the order equals ``heat_tpu``'s); across ranks it is one
row fetch per array (an ``alltoall`` of the rows each rank needs).
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Union

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle"]


def _transformed(item, t):
    """``t`` applied to a taken item's tensor (a DNDarray keeps its split)."""
    if t is None:
        return item
    if not isinstance(item, DNDarray):
        return t(item)
    out = t(item.larray)
    if item.split is None:
        return DNDarray(out, split=None, device=item.device, comm=item.comm)
    gshape = list(out.shape)
    gshape[item.split] = item.gshape[item.split]
    return DNDarray(out, gshape=tuple(gshape), split=item.split, device=item.device, comm=item.comm)


class Dataset:
    """A dataset over one or more DNDarrays of one sample axis (axis 0).

    Parameters
    ----------
    array : DNDarray or sequence of DNDarrays
    transforms : callable or list of callables, optional
        Applied to each taken item's tensor (one per array).
    shuffle : bool
        Whether the DataLoader reshuffles at each epoch's end.
    test_set : bool
        A test set is never shuffled.
    """

    def __init__(self, array, transforms=None, shuffle: bool = True, test_set: bool = False):
        arrays = [array] if isinstance(array, DNDarray) else list(array)
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the sample axis length")
        self.arrays = arrays
        self.transforms = transforms if isinstance(transforms, (list, tuple)) else [transforms] * len(arrays)
        self.shuffle_flag = shuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, index):
        out = [_transformed(a[index], t) for a, t in zip(self.arrays, self.transforms)]
        return out[0] if len(out) == 1 else tuple(out)

    def shuffle(self) -> None:
        """Epoch-end global shuffle."""
        dataset_shuffle(self)

    def ishuffle(self) -> None:
        """The same shuffle (Heat's non-blocking variant)."""
        dataset_ishuffle(self)


class DataLoader:
    """Batches of a :class:`Dataset` (or of a DNDarray) by global rows."""

    def __init__(self, dataset: Union[Dataset, DNDarray], batch_size: int = 1, drop_last: bool = True,
                 shuffle: bool = True):
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset, shuffle=shuffle)
        if not isinstance(dataset, Dataset):
            raise TypeError(f"dataset must be a Dataset or DNDarray, got {type(dataset)}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._first_epoch = True

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator:
        do_shuffle = self.shuffle and self.dataset.shuffle_flag
        if do_shuffle and not self.dataset.test_set and not self._first_epoch:
            self.dataset.shuffle()
        self._first_epoch = False
        n = len(self.dataset)
        for b in range(len(self)):
            start = b * self.batch_size
            yield self.dataset[slice(start, min(start + self.batch_size, n))]


def dataset_shuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Permute every array's global rows by one draw of the random stream."""
    n = len(dataset)
    perm = ht_random._shuffle(ht_random._next_key(n), n, dataset.arrays[0].larray.device)
    for i, a in enumerate(dataset.arrays):
        dataset.arrays[i] = a[perm.to(a.larray.device)]


def dataset_ishuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Heat's non-blocking shuffle: here the same as :func:`dataset_shuffle`."""
    dataset_shuffle(dataset, attrs)
