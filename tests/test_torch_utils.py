"""heat_tpu_torch's ``utils`` against heat_tpu, on the CPU: profiling, the
checkpoints (each package loads what the other saved), and ``utils.data``
(the gallery matrices, the shuffled Dataset/DataLoader order, the MNIST IDX
reader, the streamed HDF5 slabs, the TFRecord/HDF5/image-bytes helpers).

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
here. Every comparison is exact (equal bits): the values are copied,
permuted or drawn from the same threefry stream, never computed otherwise.
"""
import gzip
import os
import struct
from collections import OrderedDict

import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


# ---------------------------------------------------------------- profiling
def test_profiling(tmp_path):
    prof = htt.utils.profiling
    x = htt.ones((4, 3))
    prof.force_sync(x, [x.larray, {"a": x}])
    with prof.Timer() as t:
        (x.larray @ x.larray.T).sum()
    assert t.elapsed is not None and t.elapsed >= 0
    timer = prof.Timer().start()
    assert timer.stop(x) >= 0
    with prof.trace(str(tmp_path / "trace")):
        with prof.annotate("region"):
            (x.larray * 2).sum()
    written = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert written and any("region" in open(os.path.join(r, f), errors="ignore").read()
                           for r, _, fs in os.walk(tmp_path / "trace") for f in fs)


# -------------------------------------------------------------- checkpoints
def _state(pkg, seed=0):
    rng = np.random.default_rng(seed)
    w, v, b = (rng.normal(size=s).astype(np.float32) for s in ((9, 3), (5,), (2, 2)))
    return {
        "w": pkg.array(w, split=0), "layers": [pkg.array(v), pkg.array(b, split=1)],
        "count": np.arange(3, dtype=np.int64), "none": None, "lr": np.float32(0.5),
    }


def _same_state(got, want):
    np.testing.assert_array_equal(_np(got["w"]), _np(want["w"]))
    assert got["w"].split == 0 and got["layers"][1].split == 1 and got["layers"][0].split is None
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_array_equal(_np(g), _np(w))
    np.testing.assert_array_equal(_np(got["count"]), _np(want["count"]))
    assert got["none"] is None and float(_np(got["lr"])) == 0.5


def test_checkpoint_port_to_heat_tpu_and_back(tmp_path):
    htt.random.seed(11)
    htt.random.rand(7)  # move the counter on
    htt.utils.save_checkpoint(str(tmp_path / "a"), _state(htt), step=4, metadata={"epoch": 2})
    meta_files = sorted(os.listdir(tmp_path / "a"))
    assert meta_files == ["arrays.npz", "meta.json"]  # no pickle of jax's
    htj.random.seed(0)
    state, step, meta = htj.utils.load_checkpoint(str(tmp_path / "a"), like=_state(htj, seed=1))
    assert step == 4 and meta == {"epoch": 2}
    _same_state(state, _state(htj))
    assert tuple(htj.random.get_state()[:3]) == ("Threefry", 11, 7)
    # heat_tpu's save, loaded by the port
    htj.utils.save_checkpoint(str(tmp_path / "b"), _state(htj, seed=2), step=9)
    htt.random.seed(0)
    state, step, _ = htt.utils.load_checkpoint(str(tmp_path / "b"), like=_state(htt, seed=3))
    assert step == 9 and isinstance(state["w"], htt.DNDarray)
    _same_state(state, _state(htt, seed=2))
    assert tuple(htt.random.get_state()[:3]) == ("Threefry", 11, 7)
    np.testing.assert_array_equal(htt.random.rand(4).numpy(), _np(htj.random.rand(4)))
    leaves, _, _ = htt.utils.load_checkpoint(str(tmp_path / "b"), restore_rng=False)
    assert isinstance(leaves, list) and len(leaves) == 5  # heat_tpu's tree needs its pickle: leaves in jax's order
    np.testing.assert_array_equal(leaves[0], np.arange(3))  # "count" sorts first


def test_checkpoint_port_alone_rebuilds_its_tree(tmp_path):
    state = {"b": torch.arange(4.0), "a": OrderedDict([("z", np.ones(2)), ("y", (torch.zeros(1), 2.5))]),
             "c": htt.array(np.eye(3, dtype=np.float32), split=0)}
    htt.utils.save_checkpoint(str(tmp_path), state)
    got, step, meta = htt.utils.load_checkpoint(str(tmp_path))
    assert step is None and meta == {}
    assert list(got["a"]) == ["z", "y"] and isinstance(got["a"]["y"], tuple)
    np.testing.assert_array_equal(got["b"], np.arange(4.0))
    np.testing.assert_array_equal(got["c"], np.eye(3))
    like, _, _ = htt.utils.load_checkpoint(str(tmp_path), like=state)
    assert torch.equal(like["b"], state["b"]) and like["c"].split == 0 and like["a"]["y"][1] == 2.5
    with pytest.raises(ValueError, match="leaves"):
        htt.utils.load_checkpoint(str(tmp_path), like={"b": 1})


# ------------------------------------------------------------- data: gallery
def test_matrixgallery():
    for split in (None, 0, 1):
        t, j = htt.utils.data.matrixgallery.parter(7, split=split), htj.utils.data.matrixgallery.parter(7, split=split)
        assert t.split == j.split
        np.testing.assert_array_equal(t.numpy(), _np(j))
    for dtype in ("complex64", "float32"):
        htt.random.seed(5)
        htj.random.seed(5)
        t = htt.utils.data.matrixgallery.hermitian(6, dtype=getattr(htt, dtype))
        j = htj.utils.data.matrixgallery.hermitian(6, dtype=getattr(htj, dtype))
        assert t.dtype.__name__ == j.dtype.__name__
        np.testing.assert_array_equal(t.numpy(), _np(j))
        np.testing.assert_array_equal(t.numpy(), t.numpy().conj().T)


# ----------------------------------------------------- data: Dataset/loader
def test_shuffled_dataset_order_is_heat_tpus():
    x = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    y = np.arange(50, dtype=np.int64)
    htt.random.seed(3)
    htj.random.seed(3)
    dt = htt.utils.data.Dataset([htt.array(x, split=0), htt.array(y, split=0)], transforms=[lambda a: a * 2, None])
    dj = htj.utils.data.Dataset([htj.array(x, split=0), htj.array(y, split=0)], transforms=[lambda a: a * 2, None])
    lt, lj = htt.utils.data.DataLoader(dt, batch_size=8), htj.utils.data.DataLoader(dj, batch_size=8)
    assert len(lt) == len(lj) == 6
    for _ in range(3):
        batches = list(zip(lt, lj))
        assert len(batches) == 6
        for (bt, yt), (bj, yj) in batches:
            assert isinstance(bt, htt.DNDarray) and bt.split == 0 and bt.gshape == (8, 3)
            np.testing.assert_array_equal(bt.numpy(), _np(bj))
            np.testing.assert_array_equal(yt.numpy(), _np(yj))
    assert htt.random.get_state() == tuple(htj.random.get_state())
    np.testing.assert_array_equal(dt.arrays[0].numpy(), _np(dj.arrays[0].larray))
    item_t, item_j = dt[3], dj[3]
    np.testing.assert_array_equal(item_t[0].numpy(), _np(item_j[0]))
    htt.utils.data.dataset_ishuffle(dt)
    htj.utils.data.dataset_ishuffle(dj)
    np.testing.assert_array_equal(dt.arrays[1].numpy(), _np(dj.arrays[1].larray))
    # a test set and a loader without shuffling keep the order; drop_last=False keeps the tail
    lt = htt.utils.data.DataLoader(htt.utils.data.Dataset(htt.array(y), test_set=True), batch_size=16, drop_last=False)
    assert [b.numpy().tolist() for b in lt][-1] == list(range(48, 50)) and len(list(lt)) == 4
    with pytest.raises(TypeError):
        htt.utils.data.DataLoader([1, 2, 3])
    with pytest.raises(ValueError, match="sample axis"):
        htt.utils.data.Dataset([htt.array(x), htt.array(y[:4])])


# ------------------------------------------------------------ data: MNIST
def _write_idx(path, arr, gz=False):
    codes = {np.dtype(np.uint8): 0x08}
    header = struct.pack(">HBB", 0, codes[arr.dtype], arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx(tmp_path, gz):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(20, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=20).astype(np.uint8)
    sfx = ".gz" if gz else ""
    _write_idx(tmp_path / f"t10k-images-idx3-ubyte{sfx}", imgs, gz)
    _write_idx(tmp_path / f"t10k-labels-idx1-ubyte{sfx}", labels, gz)
    t = htt.utils.data.MNISTDataset(str(tmp_path), train=False, transform=htt.nn.vision_transforms.Normalize((0.5,), (0.25,)))
    j = htj.utils.data.MNISTDataset(str(tmp_path), train=False, transform=htj.nn.vision_transforms.Normalize((0.5,), (0.25,)))
    assert len(t) == len(j) == 20 and t.data.split == 0
    np.testing.assert_array_equal(t.data.numpy(), _np(j.data))
    np.testing.assert_array_equal(t.targets.numpy(), _np(j.targets))
    assert t.targets.dtype.__name__ == j.targets.dtype.__name__ == "int64"
    (it, lt), (ij, lj) = t[5], j[5]
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(lt) == int(lj)
    with pytest.raises(FileNotFoundError):
        htt.utils.data.MNISTDataset(str(tmp_path), train=True)


# ---------------------------------------------------- data: partial dataset
def test_partial_h5_dataset(tmp_path):
    import h5py

    rng = np.random.default_rng(5)
    data, labels = rng.normal(size=(23, 4)).astype(np.float32), np.arange(23)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)
        f.create_dataset("labels", data=labels)
    t = htt.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=5)
    j = htj.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=5)
    assert len(t) == len(j) == 23
    got, want = list(iter(t)), list(iter(j))
    assert len(got) == len(want) == 5
    for (a, b), (c, d) in zip(got, want):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
    it = iter(t)
    next(it)
    it.close()  # an early stop joins the producer
    assert not it._thread.is_alive()


# ----------------------------------------------------------- data: helpers
def test_tfrecord_merge_and_image_bytes(tmp_path):
    tu, ju = htt.utils.data._utils, htj.utils.data._utils
    assert tu._crc32c(b"123456789") == ju._crc32c(b"123456789") == 0xE3069283
    payloads = [b"abc", b"", b"x" * 300]
    rec = tmp_path / "records"
    rec.mkdir()
    with open(rec / "a.tfrecord", "wb") as f:
        for p in payloads:
            hdr = struct.pack("<Q", len(p))
            f.write(hdr + struct.pack("<I", tu._masked_crc32c(hdr)) + p + struct.pack("<I", tu._masked_crc32c(p)))
    (rec / "README").write_text("not a record file at all")
    assert tu.tfrecord_index(str(rec / "a.tfrecord")) == ju.tfrecord_index(str(rec / "a.tfrecord"))
    wt, wj = tu.write_tfrecord_indexes(str(rec), str(tmp_path / "it")), ju.write_tfrecord_indexes(str(rec), str(tmp_path / "ij"))
    assert [os.path.basename(p) for p in wt] == [os.path.basename(p) for p in wj] == ["a.tfrecord.idx"]
    assert open(wt[0]).read() == open(wj[0]).read()
    rng = np.random.default_rng(6)
    shards = []
    for i in range(3):
        p = str(tmp_path / f"s{i}.npz")
        np.savez(p, images=rng.integers(0, 256, size=(4 + i, 2, 2), dtype=np.uint8), labels=np.arange(4 + i))
        shards.append(p)
    import h5py

    assert tu.merge_shards_to_hdf5(shards, str(tmp_path / "t.h5")) == ju.merge_shards_to_hdf5(shards, str(tmp_path / "j.h5"))
    with h5py.File(tmp_path / "t.h5") as a, h5py.File(tmp_path / "j.h5") as b:
        np.testing.assert_array_equal(a["images"][:], b["images"][:])
        np.testing.assert_array_equal(a["labels"][:], b["labels"][:])
    img = rng.integers(0, 256, size=(3, 4, 2), dtype=np.uint8)
    s = tu.encode_image_bytes(img)
    assert s == ju.encode_image_bytes(img)
    np.testing.assert_array_equal(tu.decode_image_bytes(s, img.shape), img)
