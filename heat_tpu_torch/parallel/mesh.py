"""Meshes of the group's ranks (counterpart of ``heat_tpu/parallel/mesh.py``).

``heat_tpu`` builds ``jax.sharding.Mesh`` objects over devices; the port's
devices are the ranks of the ``torch.distributed`` group, one card each.
Where a group runs, :func:`make_mesh` and :func:`make_hierarchical_mesh`
hand back a ``torch.distributed.device_mesh.DeviceMesh`` over those ranks
(every rank must call them, as a ``DeviceMesh`` starts a subgroup per
dimension). Without a group (world size 1), ``DeviceMesh`` would start
one from the environment, so they hand back a :class:`LocalMesh`, which
answers the same questions. Shapes, axis names, errors and their messages
are ``heat_tpu``'s: a hierarchical mesh is (slow x fast), the slow axis
across hosts and the fast one within a host.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import devices as _devices
from ..core.communication import SPLIT_AXIS, get_comm

__all__ = ["LocalMesh", "make_hierarchical_mesh", "make_mesh"]


class LocalMesh:
    """A mesh of ranks without a process group: ``DeviceMesh``'s
    ``device_type``, ``mesh`` (the ranks), ``mesh_dim_names``, ``shape``,
    ``ndim``, ``size()`` and ``get_rank()``."""

    def __init__(self, device_type: str, mesh, mesh_dim_names: Tuple[str, ...]):
        self.device_type = device_type
        self.mesh = torch.as_tensor(np.asarray(mesh, dtype=np.int64))
        self.mesh_dim_names = tuple(mesh_dim_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape)

    @property
    def ndim(self) -> int:
        return self.mesh.ndim

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return self.mesh.numel() if mesh_dim is None else int(self.mesh.shape[mesh_dim])

    def get_rank(self) -> int:
        return get_comm().rank

    def __repr__(self) -> str:
        # graftlint: G004 - the mesh is a CPU tensor of ranks, read in __repr__
        return f"LocalMesh({self.device_type!r}, {self.mesh.tolist()}, mesh_dim_names={self.mesh_dim_names})"


def _mesh(ranks: np.ndarray, names: Tuple[str, ...]):
    device_type = _devices.get_device().device_type
    device_type = "cuda" if device_type == "gpu" else device_type
    if get_comm()._started():
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=names)
    return LocalMesh(device_type, ranks, names)


def _all_ranks():
    return list(range(get_comm().size))


def make_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = SPLIT_AXIS):
    """1-D mesh over the given ranks (default: all of them)."""
    ranks = _all_ranks() if devices is None else [int(d) for d in devices]
    return _mesh(np.array(ranks, dtype=np.int64), (axis_name,))


def _hosts() -> int:
    """The number of hosts: the group's size over its ranks per host
    (``LOCAL_WORLD_SIZE``, as ``torchrun`` sets it), else 1."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    size = get_comm().size
    return max(1, size // local) if local > 0 else 1


def make_hierarchical_mesh(
    n_slow: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    slow_axis: str = "nodes",
    fast_axis: str = SPLIT_AXIS,
    validate: bool = True,
):
    """2-D (slow x fast) mesh for hierarchical data parallelism. ``n_slow``
    defaults to the number of hosts, so the fast axis maps onto the cards
    of one host and the slow axis across hosts.

    ``validate=True`` checks that no rank appears twice and, when
    ``devices`` is omitted, that the mesh covers every rank exactly once;
    ``validate=False`` builds a mesh over a deliberate subset."""
    if devices is None:
        devices = _all_ranks()
        check_coverage = validate
    else:
        check_coverage = False
    devices = [int(d) for d in devices]
    if n_slow is None:
        n_slow = _hosts()
    if n_slow < 1:
        raise ValueError(f"n_slow must be >= 1, got n_slow={n_slow}")
    if len(devices) % n_slow:
        raise ValueError(
            f"cannot build a hierarchical mesh: {len(devices)} device(s) do not "
            f"divide evenly into n_slow={n_slow} group(s) "
            f"({len(devices)} % {n_slow} = {len(devices) % n_slow}); pick an "
            f"n_slow that divides the device count"
        )
    arr = np.array(devices, dtype=np.int64).reshape(n_slow, len(devices) // n_slow)
    if validate:
        _validate_mesh_devices(arr, check_coverage=check_coverage)
    return _mesh(arr, (slow_axis, fast_axis))


def _validate_mesh_devices(device_array: np.ndarray, check_coverage: bool) -> None:
    """Every rank at most once; with ``check_coverage``, every rank of the
    group exactly once."""
    ids = [int(d) for d in device_array.ravel()]
    dupes = sorted({i for i in ids if ids.count(i) > 1})
    if dupes:
        raise ValueError(f"mesh contains duplicate device id(s) {dupes}")
    if check_coverage:
        missing = [r for r in _all_ranks() if r not in set(ids)]
        if missing:
            raise ValueError(
                f"mesh does not cover addressable device id(s) {sorted(missing)}: "
                f"every addressable device must appear exactly once"
            )
