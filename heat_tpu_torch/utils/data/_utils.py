"""Data-preparation utilities (counterpart of ``heat_tpu/utils/data/_utils.py``;
pure numpy and h5py, this package's own copy).

The reference ships two standalone ImageNet helpers it explicitly marks
"not tested, nor actively supported": DALI TFRecord index generation
(``_utils.py:13``) and a TFRecord->HDF5 merger (``_utils.py:47``) that
needs TensorFlow. The equivalents here are dependency-free
(the TFRecord wire format is parsed directly) and tested:

- :func:`tfrecord_index` / :func:`write_tfrecord_indexes` — byte-offset
  indexes in the DALI text format, built by walking the record framing
  (uint64 length + masked crc32 + payload + crc32) without TensorFlow.
- :func:`merge_shards_to_hdf5` — stack per-shard ``.npy``/``.npz``
  preprocessing outputs into one chunked HDF5 file consumable by the
  parallel loader (``load_hdf5`` split reads, ``PartialH5Dataset``
  streaming), the analogue of ``merge_files_imagenet_tfrecord``.
- :func:`encode_image_bytes` / :func:`decode_image_bytes` — the
  reference's base64-ASCII image string convention (its HDF5 stores
  images as ``a2b_base64``-decodable strings; ``_utils.py:75-77``).
"""
from __future__ import annotations

import binascii
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _build_crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _build_crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the TFRecord framing checksum (table-driven:
    one lookup per byte, matches the 0xE3069283 test vector)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc: rot15(crc32c) + magic constant."""
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF

__all__ = [
    "tfrecord_index",
    "write_tfrecord_indexes",
    "merge_shards_to_hdf5",
    "encode_image_bytes",
    "decode_image_bytes",
]


def tfrecord_index(path: str) -> List[Tuple[int, int]]:
    """(offset, size) of every record in a TFRecord file.

    Walks the standard framing — ``uint64 length``, ``uint32`` masked
    crc32 of the length, ``length`` payload bytes, ``uint32`` payload
    crc — exactly like the reference's index loop (``_utils.py:24-44``),
    no TensorFlow required. Truncated trailing records raise.
    """
    entries: List[Tuple[int, int]] = []
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            start = f.tell()
            header = f.read(8)
            if not header:
                return entries
            if len(header) < 8:
                if start == 0:  # can't even hold one header: not a TFRecord
                    raise ValueError(f"not a TFRecord: {path} is too short")
                raise ValueError(f"truncated record header at byte {start} of {path}")
            (length,) = struct.unpack("<Q", header)
            # the FIRST header's masked crc32c distinguishes a genuine
            # (possibly truncated) TFRecord from an arbitrary file whose
            # bytes decode as an absurd length; past the first record the
            # same failure means in-file corruption and must surface
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4 or struct.unpack("<I", crc_bytes)[0] != _masked_crc32c(header):
                if start == 0:
                    raise ValueError(
                        f"not a TFRecord: bad header checksum at byte 0 of {path}"
                    )
                raise ValueError(f"corrupt record header at byte {start} of {path}")
            # validate BEFORE seeking past the payload: a truncated shard
            # must surface as an error, never as a silent short index
            if start + 8 + 4 + length + 4 > file_size:
                raise ValueError(f"truncated record payload at byte {start} of {path}")
            f.seek(length + 4, os.SEEK_CUR)  # payload + payload-crc
            entries.append((start, 8 + 4 + length + 4))


def write_tfrecord_indexes(data_dir: str, idx_dir: str) -> List[str]:
    """Write a DALI-style text index (``"offset size"`` per line) for every
    file in ``data_dir`` (reference ``dali_tfrecord2idx``, ``_utils.py:13``).
    Returns the written index paths."""
    os.makedirs(idx_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(data_dir)):
        src = os.path.join(data_dir, name)
        if not os.path.isfile(src):
            continue
        try:
            entries = tfrecord_index(src)
        except ValueError as e:
            # non-TFRecord files (README, checksums, ...) are skipped — the
            # header-crc check identifies them; TRUNCATED TFRecords raise
            if "not a TFRecord" in str(e):
                continue
            raise
        dst = os.path.join(idx_dir, name + ".idx")
        with open(dst, "w") as out:
            for offset, size in entries:
                out.write(f"{offset} {size}\n")
        written.append(dst)
    return written


def merge_shards_to_hdf5(
    shard_files: Sequence[str],
    output_path: str,
    dataset: str = "images",
    labels_dataset: Optional[str] = "labels",
    chunk_rows: int = 64,
) -> Tuple[int, Tuple[int, ...]]:
    """Stack per-shard arrays into one chunked HDF5 file.

    Each shard is a ``.npy`` (images only) or ``.npz`` with ``images`` and
    optionally ``labels`` arrays; shards are appended along dim 0 in the
    given order, writing directly into a resizable chunked dataset — one
    shard in memory at a time, like the reference's incremental
    ``__write_datasets`` (``_utils.py:217``). Returns
    ``(total_rows, row_shape)``.
    """
    import h5py

    if not shard_files:
        raise ValueError("no shard files given")
    total = 0
    label_rows = 0
    row_shape: Optional[Tuple[int, ...]] = None
    with h5py.File(output_path, "w") as out:
        img_ds = lab_ds = None
        for path in shard_files:
            if path.endswith(".npz"):
                with np.load(path) as z:
                    images = z["images"]
                    labels = z["labels"] if labels_dataset and "labels" in z else None
            else:
                images, labels = np.load(path), None
            if row_shape is None:
                row_shape = tuple(images.shape[1:])
                img_ds = out.create_dataset(
                    dataset,
                    shape=(0,) + row_shape,
                    maxshape=(None,) + row_shape,
                    dtype=images.dtype,
                    chunks=(chunk_rows,) + row_shape,
                )
            elif tuple(images.shape[1:]) != row_shape:
                raise ValueError(
                    f"shard {path} rows {tuple(images.shape[1:])} != {row_shape}"
                )
            if images.dtype != img_ds.dtype:
                raise ValueError(
                    f"shard {path} image dtype {images.dtype} != {img_ds.dtype}; "
                    "h5py would silently cast and corrupt the merged data"
                )
            if labels is not None and lab_ds is not None and labels.dtype != lab_ds.dtype:
                raise ValueError(
                    f"shard {path} label dtype {labels.dtype} != {lab_ds.dtype}"
                )
            n = images.shape[0]
            if labels is not None and labels.shape[0] != n:
                raise ValueError(
                    f"shard {path} has {labels.shape[0]} labels for {n} images; "
                    "a short shard would misalign every subsequent label row"
                )
            img_ds.resize(total + n, axis=0)
            img_ds[total : total + n] = images
            if labels is not None:
                if lab_ds is None and total > 0:
                    raise ValueError(
                        f"shard {path} has labels but earlier shards did not; "
                        "mixed labeled/unlabeled shards would silently "
                        "misalign the label rows"
                    )
                if lab_ds is None:
                    lab_ds = out.create_dataset(
                        labels_dataset,
                        shape=(0,),
                        maxshape=(None,),
                        dtype=labels.dtype,
                        chunks=(max(chunk_rows, 256),),
                    )
                lab_ds.resize(label_rows + n, axis=0)
                lab_ds[label_rows : label_rows + n] = labels
                label_rows += n
            elif lab_ds is not None:
                raise ValueError(
                    f"shard {path} lacks labels but earlier shards had them"
                )
            total += n
    return total, row_shape or ()


def encode_image_bytes(image: np.ndarray) -> str:
    """uint8 image array -> base64 ASCII string (the reference's HDF5
    image storage convention, ``_utils.py:75-77``)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    return binascii.b2a_base64(image.tobytes()).decode("ascii")


def decode_image_bytes(payload: str, shape: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`encode_image_bytes` (the reference documents the
    torch decode incantation; numpy equivalent here)."""
    raw = binascii.a2b_base64(payload.encode("ascii"))
    # copy: frombuffer views are read-only, augmentation pipelines mutate
    return np.frombuffer(raw, dtype=np.uint8).reshape(tuple(shape)).copy()
