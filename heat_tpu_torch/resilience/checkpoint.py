"""Sharded, checksummed, atomic checkpoints of DNDarrays (counterpart of
``heat_tpu/resilience/checkpoint.py``, in its directory format).

A checkpoint directory::

    ckpt/
      manifest.json          # committed LAST (atomic rename): the commit point
      shard_000000000000.npy # one .npy per rank's shard, named by its
      shard_000000000003.npy # global offset along the split axis

``manifest.json`` (format ``heat_tpu.checkpoint.v1``) holds the global
shape, the dtype's numpy name, the split axis, the writer's mesh (axis
sizes, split size, processes), the checksum algorithm (crc32 or sha256)
and per shard ``{file, offset, length, shape, checksum}``. Every file is
written atomically (a temp file, then ``os.replace``:
:mod:`heat_tpu_torch.core._atomic`), and the manifest only after every
shard is durable, so a crashed save never presents half a checkpoint.

The format is ``heat_tpu``'s: either package loads what the other saved, at
any world size, and the shard files of one array in one layout are byte for
byte the same (``numpy.save`` of the shard). The manifests agree but in the
fields that name the writer's mesh and processes: the port writes
``{"axis_sizes": {"split": P}, "split_size": P, "processes": P}`` for P
ranks, one process each. bfloat16, which numpy lacks, is written as
``heat_tpu`` (``ml_dtypes``) writes it: its 16-bit patterns under the
``.npy`` descr ``'<V2'``, with ``"dtype": "bfloat16"`` in the manifest,
which is what the port reads it by.

A load checks each shard's checksum before its values are used (a mismatch
raises :class:`CheckpointCorruptionError` naming the file and both digests)
and rebuilds the array on the *current* communicator: each rank assembles
its ceil-div chunk from whatever shard files overlap it, so the saving and
the loading world sizes are independent.

Every file operation runs under a
:class:`~heat_tpu_torch.resilience.retry.RetryPolicy` (by default
:data:`~heat_tpu_torch.resilience.retry.DEFAULT_CHECKPOINT_POLICY`); the
fault points ``checkpoint.shard``, ``checkpoint.manifest`` and
``checkpoint.read`` sit inside the retried calls. Above one rank, a failure
on any rank raises on every rank (a status ``allgather`` after each
phase), so no rank deserts the next collective.
"""
from __future__ import annotations

import hashlib
import io as _io
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import _hooks, devices, types
from ..core._atomic import atomic_write_bytes
from ..core.communication import ragged_process_allgather, sanitize_comm
from ..core.dndarray import DNDarray
from ..core.io import _check_path_visible
from ..core.sanitation import sanitize_in, sanitize_split
from .errors import ResilienceError
from .retry import DEFAULT_CHECKPOINT_POLICY, RetryPolicy

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "read_manifest",
    "CheckpointError",
    "CheckpointCorruptionError",
    "MANIFEST_NAME",
    "CHECKPOINT_FORMAT",
]

MANIFEST_NAME = "manifest.json"
CHECKPOINT_FORMAT = "heat_tpu.checkpoint.v1"


class CheckpointError(ResilienceError):
    """Structurally invalid or unreadable checkpoint."""


class CheckpointCorruptionError(CheckpointError):
    """A shard file's bytes do not match the manifest checksum."""


def _replicated_raise(label: str, err: Optional[BaseException], comm) -> None:
    """Every rank learns whether ANY rank failed ``label`` (one
    ``allgather`` of a flag above one rank) and all raise together: the
    failing rank its own error, the others a :class:`CheckpointError` naming
    the failing ranks."""
    if comm.is_distributed():
        flag = torch.tensor([[0 if err is None else 1]], dtype=torch.int32, device=comm.device())
        statuses = comm.allgather(flag, 0, [1] * comm.size).reshape(-1).cpu().numpy()
        if err is None and statuses.any():
            raise CheckpointError(
                f"{label} failed on process(es) {np.nonzero(statuses)[0].tolist()} "
                "— raising on every process instead of deserting the next collective"
            )
    if err is not None:
        raise err


def _digest(data: bytes, algo: str) -> str:
    if algo == "crc32":
        return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    if algo == "sha256":
        return hashlib.sha256(data).hexdigest()
    raise ValueError(f"unknown checksum algorithm {algo!r} (crc32 or sha256)")


def _shard_filename(offset: int) -> str:
    return f"shard_{offset:012d}.npy"


def _npy_bytes(t: torch.Tensor) -> bytearray:
    """``numpy.save``'s bytes of a tensor's values (``heat_tpu``'s shard
    file), built with one copy of the values after the device's; bfloat16 as
    its 16-bit patterns under ml_dtypes' descr ``'<V2'``."""
    t = t.detach().contiguous().cpu()
    arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    head = np.lib.format.header_data_from_array_1_0(arr)
    if t.dtype == torch.bfloat16:
        head["descr"] = "<V2"
    bio = _io.BytesIO()
    np.lib.format.write_array_header_1_0(bio, head)
    header = bio.getvalue()
    payload = bytearray(len(header) + arr.nbytes)
    payload[: len(header)] = header
    payload[len(header) :] = memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")
    return payload


def _npy_array(raw: bytearray) -> np.ndarray:
    """The array of ``.npy`` bytes, a view of ``raw`` (``numpy.load``'s for a
    Fortran-ordered file); its descr as written (``'<V2'`` for bfloat16)."""
    bio = _io.BytesIO(raw)
    version = np.lib.format.read_magic(bio)
    readers = {(1, 0): np.lib.format.read_array_header_1_0, (2, 0): np.lib.format.read_array_header_2_0}
    if version not in readers:
        return np.load(_io.BytesIO(raw), allow_pickle=False)
    shape, fortran, dtype = readers[version](bio)
    if fortran or dtype.hasobject:
        return np.load(_io.BytesIO(raw), allow_pickle=False)
    count = int(np.prod(shape, dtype=np.int64))
    return np.frombuffer(raw, dtype=dtype, count=count, offset=bio.tell()).reshape(shape)


def _tensor_of(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A shard's numpy values as a tensor of heat type ``dtype``."""
    if dtype is types.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype.torch_type())


def _local_shards(x: DNDarray) -> List[Tuple[int, torch.Tensor]]:
    """(global offset, tensor) of every shard this rank writes: its rows of
    a split array (an empty chunk writes nothing), the whole of a
    replicated one on rank 0."""
    comm = x.comm
    if x.split is None:
        return [(0, x._raw)] if comm.rank == 0 else []
    counts, displs = x.counts_displs()
    if counts[comm.rank] == 0:
        return []
    return [(int(displs[comm.rank]), x._raw)]


def save_checkpoint(x: DNDarray, directory: str, *, checksum: str = "crc32", retry: Optional[RetryPolicy] = None) -> str:
    """Write ``x`` as a sharded checkpoint under ``directory``; returns the
    manifest's path.

    Each rank writes its own shard (``split=None``: rank 0 writes the one
    shard); rank 0 commits the manifest once every shard is durable, then
    removes shard files the manifest does not name. Collectives above one
    rank: a barrier on entry, a status ``allgather`` after the shard
    writes, the entries' ``allgather``, a barrier and a status
    ``allgather`` around the manifest, a barrier after the sweep.
    """
    sanitize_in(x)
    comm = x.comm
    policy = retry or DEFAULT_CHECKPOINT_POLICY
    _digest(b"", checksum)  # the algorithm's name, checked up front
    if comm.is_distributed():
        # a re-save changes the directory in place: no rank starts writing
        # while another could still read the previous save
        comm.barrier()
    entries: List[Dict] = []
    err: Optional[BaseException] = None
    try:
        os.makedirs(directory, exist_ok=True)
        for offset, t in _local_shards(x):
            payload = _npy_bytes(t)
            digest = _digest(payload, checksum)  # before the write path
            fname = _shard_filename(offset)
            fpath = os.path.join(directory, fname)

            def write_shard(fpath=fpath, payload=payload, offset=offset):
                # the fault point sits inside the retried call, and each
                # attempt stages a fresh copy of the payload
                _hooks.fault_point("checkpoint.shard", path=fpath, offset=offset)
                atomic_write_bytes(fpath, payload)

            policy.call(write_shard, label=f"checkpoint shard {fname}")
            entries.append({
                "file": fname,
                "offset": offset,
                "length": int(t.shape[x.split]) if x.split is not None else 0,
                "shape": [int(s) for s in t.shape],
                "checksum": digest,
            })
    except BaseException as e:  # noqa: BLE001 - re-raised by _replicated_raise
        err = e
    _replicated_raise("checkpoint shard write", err, comm)

    if comm.is_distributed() and x.split is not None:
        # every rank's entries to every rank: (offset, length, digest words)
        hexlen = len(_digest(b"", checksum))
        nwords = (hexlen + 7) // 8
        rows = [[int(e["offset"]), int(e["length"])]
                + [int(e["checksum"][8 * i : 8 * (i + 1)].ljust(8, "0"), 16) for i in range(nwords)]
                for e in entries]
        packed = np.asarray(rows, dtype=np.int64).reshape(-1, 2 + nwords)
        gathered = np.concatenate(ragged_process_allgather(packed, axis=0, comm=comm), axis=0)
        entries = []
        for row in sorted(set(map(tuple, gathered.tolist()))):
            offset, length = int(row[0]), int(row[1])
            shape = list(x.gshape)
            shape[x.split] = length
            entries.append({
                "file": _shard_filename(offset),
                "offset": offset,
                "length": length,
                "shape": [int(s) for s in shape],
                "checksum": "".join(f"{int(w):08x}" for w in row[2:])[:hexlen],
            })

    manifest_path = os.path.join(directory, MANIFEST_NAME)
    err = None
    try:
        if comm.rank == 0:
            manifest = {
                "format": CHECKPOINT_FORMAT,
                "gshape": [int(s) for s in x.gshape],
                "dtype": x.dtype.__name__,  # numpy's name of the type (bfloat16: ml_dtypes')
                "split": x.split,
                "mesh": {
                    "axis_sizes": {"split": int(comm.size)},
                    "split_size": int(comm.size),
                    "processes": int(comm.size),
                },
                "checksum": checksum,
                "nshards": len(entries),
                "shards": sorted(entries, key=lambda e: e["offset"]),
            }
            payload = json.dumps(manifest, indent=1).encode()
            policy.call(atomic_write_bytes, manifest_path, payload, label="checkpoint manifest")
    except BaseException as e:  # noqa: BLE001 - re-raised by _replicated_raise
        err = e
    if comm.is_distributed():
        comm.barrier()
    _replicated_raise("checkpoint manifest commit", err, comm)
    if comm.rank == 0:
        _gc_stale_shards(directory, entries)
    if comm.is_distributed():
        comm.barrier()  # a caller listing the directory after the save sees the sweep done
    return manifest_path


def _gc_stale_shards(directory: str, entries: List[Dict]) -> int:
    """Remove the shard files the just-committed manifest does not name (a
    save at another world size writes other offsets); after the commit, so
    a crash here leaves extra files the loader ignores. Returns how many
    were removed."""
    keep = {e["file"] for e in entries} | {MANIFEST_NAME}
    removed = 0
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("shard_") and name.endswith(".npy")) or name in keep:
            continue
        try:
            os.remove(os.path.join(directory, name))
            removed += 1
        except OSError:
            continue  # the loader reads only the manifest's shards, so never fail the save
    if removed:
        _hooks.observe("checkpoint.gc", directory=directory, removed=removed)
    return removed


def read_manifest(directory: str) -> Dict:
    """Parse ``directory``'s manifest and check its structure."""
    manifest_path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no checkpoint manifest at {manifest_path} (incomplete or missing checkpoint)")
    _hooks.fault_point("checkpoint.manifest", path=manifest_path)
    with open(manifest_path, "rb") as f:
        raw = f.read()
    try:
        manifest = json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointCorruptionError(f"manifest {manifest_path} is not valid JSON: {e}") from e
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise CheckpointError(
            f"unsupported checkpoint format {manifest.get('format')!r} "
            f"(expected {CHECKPOINT_FORMAT!r}) in {manifest_path}"
        )
    for key in ("gshape", "dtype", "shards", "checksum"):
        if key not in manifest:
            raise CheckpointError(f"manifest {manifest_path} is missing key {key!r}")
    return manifest


def _read_shard(directory: str, entry: Dict, algo: str, verify: bool) -> np.ndarray:
    path = os.path.join(directory, entry["file"])
    if not os.path.exists(path):
        raise CheckpointError(f"manifest names shard {entry['file']} but {path} does not exist")
    _hooks.fault_point("checkpoint.read", path=path)
    raw = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(raw)
    if verify:
        actual = _digest(raw, algo)
        if actual != entry["checksum"]:
            raise CheckpointCorruptionError(
                f"shard {path} failed {algo} verification: manifest says "
                f"{entry['checksum']}, file hashes to {actual} — the shard was "
                f"corrupted after it was written (torn write, bitrot, or tampering)"
            )
    try:
        arr = _npy_array(raw)
    except ValueError as e:
        raise CheckpointCorruptionError(f"shard {path} is not a readable .npy file: {e}") from e
    if list(arr.shape) != list(entry.get("shape", arr.shape)):
        raise CheckpointCorruptionError(f"shard {path} has shape {list(arr.shape)}, manifest says {entry['shape']}")
    return arr


def load_checkpoint(directory: str, *, device=None, comm=None, retry: Optional[RetryPolicy] = None,
                    verify: bool = True) -> DNDarray:
    """Restore a checkpoint of :func:`save_checkpoint` (either package's).

    The array is rebuilt on the *current* communicator: each rank assembles
    its ceil-div chunk from the shard files that overlap it, whatever the
    world size of the save (the manifest's mesh is informational).
    ``verify=True`` (default) checks every shard it reads against the
    manifest's checksum first.
    """
    policy = retry or DEFAULT_CHECKPOINT_POLICY
    comm = sanitize_comm(comm)
    # a missing manifest is a missing checkpoint, not a transient fault: no retry
    _check_path_visible(os.path.join(directory, MANIFEST_NAME), comm)
    err: Optional[BaseException] = None
    out = None
    try:
        manifest = policy.call(read_manifest, directory, label=f"read manifest {directory}")
        device = devices.sanitize_device(device)
        dtype = types.canonical_heat_type(manifest["dtype"])
        gshape = tuple(int(s) for s in manifest["gshape"])
        split = manifest.get("split")
        split = sanitize_split(gshape, split) if split is not None else None
        algo = manifest["checksum"]
        entries = sorted(manifest["shards"], key=lambda e: e["offset"])

        def shard_array(entry: Dict) -> np.ndarray:
            return policy.call(_read_shard, directory, entry, algo, verify, label=f"checkpoint shard {entry['file']}")

        dev = device.torch_device
        if split is None:
            if len(entries) != 1:
                raise CheckpointError(f"split=None checkpoint must have exactly 1 shard, manifest lists {len(entries)}")
            arr = shard_array(entries[0])
            if tuple(arr.shape) != gshape:
                raise CheckpointCorruptionError(f"shard shape {tuple(arr.shape)} != manifest gshape {gshape}")
            out = DNDarray(_tensor_of(arr, dtype, dev), gshape=gshape, dtype=dtype, split=None, device=device,
                           comm=comm)
        else:
            n = gshape[split]
            cursor = 0
            for e in entries:  # the shards must tile [0, n)
                if int(e["offset"]) != cursor:
                    raise CheckpointError(
                        f"shards do not tile the split axis: expected offset {cursor}, "
                        f"manifest has {e['offset']} ({e['file']})"
                    )
                cursor += int(e["length"])
            if cursor != n:
                raise CheckpointError(f"shards cover [0, {cursor}) but the split extent is {n}")
            _, lshape, slices = comm.chunk(gshape, split)
            lo, hi = slices[split].start, slices[split].stop
            parts = []
            for e in entries:
                e_lo, e_hi = int(e["offset"]), int(e["offset"]) + int(e["length"])
                if e_hi <= lo or e_lo >= hi:
                    continue
                local = list(slices)
                local[split] = slice(max(lo, e_lo) - e_lo, min(hi, e_hi) - e_lo)
                parts.append(_tensor_of(shard_array(e)[tuple(local)], dtype, dev))
            if parts:
                t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=split)
            else:
                t = torch.zeros(lshape, dtype=dtype.torch_type(), device=dev)
            out = DNDarray(t, gshape=gshape, dtype=dtype, split=split, device=device, comm=comm)
    except BaseException as e:  # noqa: BLE001 - re-raised by _replicated_raise
        err = e
    # every rank agrees the checkpoint was readable, or all raise
    _replicated_raise("checkpoint load", err, comm)
    return out
