"""Resident model registry: named fitted estimators held on the cards
(counterpart of ``heat_tpu/serve/session.py``).

A service keeps one :class:`ModelRegistry` alive for its lifetime. Every
estimator that can serve (``KMeans``, ``Lasso``, ``KNeighborsClassifier``,
anything with sklearn-style methods) registers under a name; endpoints
resolve the name at dispatch time, so a re-``register`` (model refresh)
swaps what later batches see.

Snapshots are in ``heat_tpu``'s layout: a ``registry.json`` manifest and,
per model, one checkpoint directory per array entry of its
``state_dict()`` (:func:`heat_tpu_torch.resilience.save_checkpoint`:
checksummed shards, atomic manifest), the scalars in the manifest. A
snapshot written by either package restores into the other's registry.
Models without ``state_dict`` (``KNeighborsClassifier``) are listed as
skipped, as in ``heat_tpu``. Restore lands on the current default
communicator, so a snapshot taken before a shrink restores onto the
survivors.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..core.communication import get_comm
from ..core.dndarray import DNDarray
from ..core.io import _check_path_visible
from ..resilience import load_checkpoint, save_checkpoint
from ..resilience.checkpoint import _replicated_raise

__all__ = ["ModelRegistry"]

_MANIFEST = "registry.json"


class ModelRegistry:
    """Thread-safe name -> estimator map with checkpoint snapshots."""

    def __init__(self):
        self._models: Dict[str, object] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------- registry
    def register(self, name: str, model) -> None:
        """Install (or replace) ``model`` under ``name``."""
        if not name or "/" in name:
            raise ValueError(f"invalid model name: {name!r}")
        with self._lock:
            self._models[name] = model

    def get(self, name: str):
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError(f"no model registered under {name!r}; known: {sorted(self._models)}") from None

    def remove(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    # ------------------------------------------------------------ snapshots
    def snapshot(self, directory: str) -> str:
        """Write every registered model's ``state_dict`` under
        ``directory`` (one subdirectory per model, one checkpoint per array
        entry). Models without a ``state_dict`` are listed in the manifest
        as skipped. The manifest is written by rank 0 of the default
        communicator, a failure raising on every rank alike. Returns the
        manifest path."""
        with self._lock:
            items = list(self._models.items())
        manifest: Dict[str, dict] = {}
        for name, model in items:
            state_fn = getattr(model, "state_dict", None)
            if state_fn is None:
                manifest[name] = {"skipped": "no state_dict"}
                continue
            scalars, arrays = {}, []
            for key, value in state_fn().items():
                if isinstance(value, DNDarray):
                    value = value.numpy()
                if isinstance(value, np.ndarray):
                    save_checkpoint(DNDarray(value, split=None), os.path.join(directory, name, key))
                    arrays.append(key)
                else:
                    scalars[key] = value
            manifest[name] = {"scalars": scalars, "arrays": arrays}
        path = os.path.join(directory, _MANIFEST)
        comm = get_comm()
        err = None
        if comm.rank == 0:
            try:
                os.makedirs(directory, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(manifest, f, indent=1, sort_keys=True, default=str)
                os.replace(tmp, path)
            except Exception as exc:  # noqa: BLE001 - re-raised on every rank alike
                err = exc
        _replicated_raise("serve.registry_manifest", err, comm)
        return path

    def restore(self, directory: str, names: Optional[Iterable[str]] = None) -> List[str]:
        """Load a :meth:`snapshot` (this package's or ``heat_tpu``'s) back
        into the currently registered models (each must already be
        registered: the snapshot stores state, not code), onto the default
        communicator. A manifest that some rank cannot read raises on every
        rank alike. Returns the restored names."""
        path = os.path.join(directory, _MANIFEST)
        comm = get_comm()
        manifest, err = None, None
        try:
            _check_path_visible(path, comm)
            with open(path) as f:
                manifest = json.load(f)
        except Exception as exc:  # noqa: BLE001 - re-raised on every rank alike
            err = exc
        _replicated_raise("registry restore", err, comm)
        wanted = set(names) if names is not None else None
        restored: List[str] = []
        for name, entry in manifest.items():
            if wanted is not None and name not in wanted:
                continue
            if "skipped" in entry or name not in self:
                continue
            state = dict(entry["scalars"])
            for key in entry["arrays"]:
                state[key] = load_checkpoint(os.path.join(directory, name, key)).numpy()
            self.get(name).load_state_dict(state)
            restored.append(name)
        return restored
