"""Streaming dataset for larger-than-memory HDF5 files (counterpart of
``heat_tpu/utils/data/partial_dataset.py``).

A producer thread reads the next slab of rows from disk while the caller
consumes the current one; each slab is copied to the default device from
pinned memory without blocking (on a card), so host reads overlap device
work.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from ...core import devices
from ...core.communication import sanitize_comm

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter", "queue_thread"]


def queue_thread(q: "queue.Queue", fn, *args) -> threading.Thread:
    """Run ``fn(*args)`` pushing results into ``q`` on a daemon thread
    (Heat's ``queue_thread``)."""
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


class PartialH5Dataset:
    """Iterate an HDF5 dataset in slabs without loading it fully (Heat's
    ``PartialH5Dataset``).

    Parameters
    ----------
    file : str
        Path to the HDF5 file.
    dataset_names : list of str
        Datasets to read in lock-step (e.g. ["data", "labels"]).
    initial_load : int
        Rows per slab held in memory at once.
    transforms : callable(s), optional
    use_gpu : bool
        Kept for Heat's signature; slabs are placed on the default device.
    """

    def __init__(
        self,
        file: str,
        comm=None,
        dataset_names="data",
        transforms=None,
        use_gpu: bool = True,
        validate_set: bool = False,
        initial_load: int = 7000,
        load_length: Optional[int] = None,
    ):
        import h5py

        self.file = file
        self.comm = sanitize_comm(comm)
        self.dataset_names = [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        self.transforms = transforms if isinstance(transforms, (list, tuple)) else [transforms] * len(
            self.dataset_names
        )
        self.load_len = int(load_length or initial_load)
        self.validate_set = validate_set
        self.device = devices.get_device()
        with h5py.File(file, "r") as handle:
            self.total_size = handle[self.dataset_names[0]].shape[0]

    def __len__(self) -> int:
        return self.total_size

    def _read_slab(self, start: int, stop: int) -> List[np.ndarray]:
        import h5py

        with h5py.File(self.file, "r") as handle:
            return [np.asarray(handle[name][start:stop]) for name in self.dataset_names]

    def __iter__(self) -> "PartialH5DataLoaderIter":
        return PartialH5DataLoaderIter(self)


class PartialH5DataLoaderIter:
    """Background-prefetching slab iterator (Heat's
    ``PartialH5DataLoaderIter``).

    Hardened against the classic producer-thread leaks: the bounded queue
    is fed with interruptible timed puts (never a blocking ``put`` into a
    full queue the consumer has abandoned), reader exceptions travel
    through the queue and re-raise in the consumer's ``__next__`` (the
    ``None`` sentinel still follows, so iteration can never hang on a dead
    producer), and :meth:`close` — also run by ``__del__`` and the context
    manager — stops the producer, drains the queue, and joins the thread
    on early teardown (``break`` out of a loop mid-epoch).
    """

    def __init__(self, dataset: PartialH5Dataset):
        self.dataset = dataset
        # maxsize bounds staging to 2 slabs beyond the one being consumed
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._offsets = list(range(0, dataset.total_size, dataset.load_len))
        self._stop = threading.Event()
        self._closed = False
        self._thread = queue_thread(self._q, self._producer)

    def _put(self, item) -> bool:
        """Timed-put loop: blocks only until the queue drains OR the
        consumer signals stop — the producer can always exit."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            for start in self._offsets:
                if self._stop.is_set():
                    return
                stop = min(start + self.dataset.load_len, self.dataset.total_size)
                slab = self.dataset._read_slab(start, stop)
                out = []
                tdev = self.dataset.device.torch_device
                for arr, t in zip(slab, self.dataset.transforms):
                    j = torch.from_numpy(np.ascontiguousarray(arr))
                    if tdev.type == "cuda":  # asynchronous copy from pinned memory, overlaps the next read
                        j = j.pin_memory().to(tdev, non_blocking=True)
                    if t is not None:
                        j = t(j)
                    out.append(j)
                if not self._put(out[0] if len(out) == 1 else tuple(out)):
                    return
        except BaseException as exc:  # noqa: BLE001 - surfaced to the consumer
            self._put(exc)
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # producer died without delivering its sentinel (e.g.
                    # interpreter teardown killed the daemon) — never hang
                    raise StopIteration
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        """Stop the producer and join its thread; safe to call twice."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while self._thread.is_alive():
            try:  # drain so a blocked timed put can complete and exit
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __enter__(self) -> "PartialH5DataLoaderIter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        # graftlint: G006 - interpreter teardown: modules may already be gone
        except Exception:
            pass
