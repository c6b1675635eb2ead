"""Checkpoint / resume (counterpart of ``heat_tpu/utils/checkpointing.py``).

A checkpoint is a directory in ``heat_tpu``'s layout: ``arrays.npz`` holds
the state's leaves (``"0"``, ``"1"``, ... as host arrays), and
``meta.json`` holds ``step``, ``metadata``, ``n_leaves``, ``splits`` (the
split of each DNDarray leaf, by leaf index) and ``rng_state`` (the random
stream's state). The leaves are numbered in jax's pytree order: a dict's
keys sorted (an ``OrderedDict`` in its own order), lists and tuples in
order, ``None`` an empty subtree; so either package loads what the other
saved, given a ``like`` tree of the same structure.

``heat_tpu`` also pickles jax's tree definition (``treedef.pkl``), which
this package cannot read. This package writes no pickle: it records its
own description of the tree under ``"structure"`` in ``meta.json``, from
which :func:`load_checkpoint` rebuilds the tree when no ``like`` is given.
A checkpoint of ``heat_tpu``'s loaded without ``like`` gives its leaves as
a list (one leaf: the leaf), as ``heat_tpu`` does without its pickle.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import factories
from ..core import random as ht_random
from ..core.communication import get_comm
from ..core.dndarray import DNDarray

__all__ = ["save_checkpoint", "load_checkpoint"]

_META = "meta.json"
_ARRAYS = "arrays.npz"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in jax's order; returns the
    JSON description of its structure."""
    if tree is None:
        return {"none": None}
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, OrderedDict) else sorted(tree)
        kind = "odict" if isinstance(tree, OrderedDict) else "dict"
        return {kind: [[k, _flatten(tree[k], leaves)] for k in keys]}
    if _is_namedtuple(tree):
        return {"tuple": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple": [_flatten(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _unflatten(spec, leaves):
    (kind, body), = spec.items()
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[body]
    if kind in ("dict", "odict"):
        items = [(k, _unflatten(v, leaves)) for k, v in body]
        return OrderedDict(items) if kind == "odict" else dict(items)
    out = [_unflatten(v, leaves) for v in body]
    return out if kind == "list" else tuple(out)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DNDarray):
        return np.asarray(leaf.numpy())
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, step: Optional[int] = None, metadata: Optional[Dict] = None) -> None:
    """Write a checkpoint directory of ``state``, a tree of DNDarrays,
    tensors, numpy arrays and scalars. DNDarray leaves are gathered (every
    rank takes part) and recorded with their split; rank 0 writes."""
    leaves: list = []
    structure = _flatten(state, leaves)
    splits = {str(i): leaf.split for i, leaf in enumerate(leaves) if isinstance(leaf, DNDarray)}
    arrays = {str(i): _host(leaf) for i, leaf in enumerate(leaves)}
    comm = get_comm()
    if comm.rank == 0:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, _ARRAYS), **arrays)
        meta = {
            "step": step,
            "metadata": metadata or {},
            "n_leaves": len(leaves),
            "splits": splits,
            "rng_state": list(ht_random.get_state()),
            "structure": structure,
        }
        with open(os.path.join(path, _META), "w") as f:
            json.dump(meta, f)
    if comm.is_distributed():
        comm.barrier()


def _restore(old, new: np.ndarray, split):
    if isinstance(old, DNDarray):
        return factories.array(new, dtype=old.dtype, split=split, device=old.device, comm=old.comm)
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(new).to(device=old.device, dtype=old.dtype)
    if isinstance(old, np.ndarray):
        return np.asarray(new, dtype=old.dtype)
    if isinstance(old, (bool, int, float, complex)):
        return type(old)(new.item())
    return new


def load_checkpoint(path: str, like: Any = None, restore_rng: bool = True):
    """Restore a checkpoint: ``(state, step, metadata)``.

    With ``like`` (a tree of the saved structure, e.g. freshly initialized
    parameters) each leaf is replaced by its stored value in the like
    leaf's type, device and dtype; DNDarray leaves get their recorded
    splits. Without it the tree is rebuilt from ``meta.json`` with numpy
    leaves. ``restore_rng`` restores the random stream's state."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as data:
        n = meta["n_leaves"]
        stored = [data[str(i)] for i in range(n)]
    if restore_rng and meta.get("rng_state"):
        s = meta["rng_state"]
        ht_random.set_state((s[0], int(s[1]), int(s[2]), int(s[3]), float(s[4])))
    if like is None:
        if "structure" in meta:
            state = _unflatten(meta["structure"], stored)
        else:
            state = stored if n != 1 else stored[0]
    else:
        leaves: list = []
        structure = _flatten(like, leaves)
        if len(leaves) != n:
            raise ValueError(f"checkpoint has {n} leaves, 'like' tree has {len(leaves)}")
        new = [_restore(old, s, meta["splits"].get(str(i), getattr(old, "split", None)))
               for i, (old, s) in enumerate(zip(leaves, stored))]
        state = _unflatten(structure, new)
    return state, meta.get("step"), meta.get("metadata", {})
