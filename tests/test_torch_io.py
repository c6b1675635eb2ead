"""heat_tpu_torch's file I/O against heat_tpu's, on the CPU.

A file written by one package is loaded by the other: HDF5, classic
netCDF (CDF-1 and CDF-2, through each package's own numpy reader and
writer) and CSV, at split None/0/1 and with ``start``/``stop`` row
windows. heat_tpu runs under ``comm_context(SELF)``, at world size 1 as
the port does (tests/test_torch_dist.py holds the loads across ranks).

Tolerances: none. Values move through files exactly (CSV holds ``%f``
text, which both packages write and parse alike), so loaded arrays must
be equal, with dtype, ``gshape``, ``split`` and ``lshape_map``; classic
netCDF and CSV files written by the two packages must be equal byte for
byte.
"""
import os

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core import _netcdf3 as ref_nc3
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch import native
from heat_tpu_torch.core import _hooks, _netcdf3

DATA = np.random.default_rng(12).normal(size=(13, 5)).astype(np.float32)
FORMATS = {
    "hdf5": (".h5", ("data",), {}),
    "cdf1": (".nc", ("data",), {"format": "NETCDF3_CLASSIC"}),
    "cdf2": (".nc", ("data",), {"format": "NETCDF3_64BIT"}),
    "csv": (".csv", (), {}),
}
WINDOWS = [(None, None), (2, 9), (4, None)]


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)
        _hooks.set_injector(None)


def _as_text(a):
    return np.vectorize(lambda v: float("%f" % v))(a).astype(a.dtype)


def _same(t, j):
    assert isinstance(t, htt.DNDarray) and isinstance(j, htj.DNDarray)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["port", "heat_tpu"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_a_file_one_package_saves_loads_in_the_other(tmp_path, fmt, writer, split, window):
    ext, args, kwargs = FORMATS[fmt]
    path = str(tmp_path / f"x{ext}")
    w, r = (htt, htj) if writer == "port" else (htj, htt)
    w.save(w.array(DATA, split=0), path, *args, **kwargs)
    start, stop = window
    got = r.load(path, *args, split=split, start=start, stop=stop)
    mine = w.load(path, *args, split=split, start=start, stop=stop)
    pair = (mine, got) if writer == "port" else (got, mine)
    _same(*pair)
    want = _as_text(DATA) if fmt == "csv" else DATA  # a CSV holds six decimals
    np.testing.assert_array_equal(pair[0].numpy(), want[start:stop])


@pytest.mark.parametrize("fmt", ["cdf1", "cdf2", "csv"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
def test_classic_netcdf_and_csv_files_are_byte_identical(tmp_path, fmt, dtype):
    ext, args, kwargs = FORMATS[fmt]
    a = (DATA * 100).astype(dtype)
    htt.save(htt.array(a, split=1), str(tmp_path / f"p{ext}"), *args, **kwargs)
    htj.save(htj.array(a, split=1), str(tmp_path / f"j{ext}"), *args, **kwargs)
    assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    loaded = [pkg.load(str(tmp_path / f"p{ext}"), *args, dtype=getattr(pkg, dtype)) for pkg in (htt, htj)]
    _same(*loaded)


def test_csv_header_separator_and_one_dimensional_data(tmp_path):
    path = str(tmp_path / "h.csv")
    v = DATA[:, 0]
    htt.save_csv(htt.array(v), path, header_lines=["a", "b"], sep=";", decimals=3)
    htj.save_csv(htj.array(v), str(tmp_path / "j.csv"), header_lines=["a", "b"], sep=";", decimals=3)
    assert open(path).read() == open(str(tmp_path / "j.csv")).read()
    _same(htt.load_csv(path, header_lines=2, sep=";", split=0), htj.load_csv(path, header_lines=2, sep=";", split=0))


def test_the_native_parser_equals_the_python_route(tmp_path):
    """The same file through the native parser (a whole-file load), and
    through heat_tpu's Python route (a windowed load, which loadtxt
    parses); KERNEL_STATS names each route."""
    path = str(tmp_path / "n.csv")
    rows = ["# header", "+1.5, -2e-3 ,nan", "  3,4.25,inf", "", "-0.0,1e300,7"]
    open(path, "w").write("\n".join(rows) + "\n")
    htt.kernels.reset_kernel_stats()
    fast = htt.load_csv(path, header_lines=1, dtype=htt.float64)
    assert htt.KERNEL_STATS.get("csv.native") == 1 and "csv.python" not in htt.KERNEL_STATS
    slow = htt.load_csv(path, header_lines=1, dtype=htt.float64, start=0, stop=10)
    assert htt.KERNEL_STATS.get("csv.python") == 1
    np.testing.assert_array_equal(fast.numpy(), slow.numpy())
    np.testing.assert_array_equal(fast.numpy(), native.csv_parse(path, 1, ",", np.float64))
    _same(fast, htj.load_csv(path, header_lines=1, dtype=htj.float64))
    assert native.csv_dims(path, 1) == (3, 3)


@pytest.mark.parametrize("offset,length,chunk,depth", [(0, None, 1 << 10, 2), (7, 5000, 333, 1), (100, 0, 64, 3)])
def test_native_file_stream_reads_a_byte_range_in_slabs(tmp_path, offset, length, chunk, depth):
    """The native read-ahead stream (src/stream.cpp): the slabs of a byte
    range, in order, equal the file's bytes there."""
    path = tmp_path / "b.bin"
    payload = np.random.default_rng(3).integers(0, 256, 20000, dtype=np.uint8).tobytes()
    path.write_bytes(payload)
    with native.FileStream(str(path), offset, length, chunk, depth) as fs:
        slabs = list(fs)
    want = payload[offset:] if length is None else payload[offset:offset + length]
    assert all(len(s) <= chunk for s in slabs)
    assert b"".join(s.tobytes() for s in slabs) == want


def test_a_file_the_native_parser_refuses_takes_heat_tpus_python_route(tmp_path):
    """Heat parses every field with float(): underscore numerals included,
    which from_chars refuses."""
    path = str(tmp_path / "u.csv")
    open(path, "w").write("1_5,2\n3,4\n")
    assert native.csv_parse(path) is None
    htt.kernels.reset_kernel_stats()
    t = htt.load_csv(path)
    assert htt.KERNEL_STATS.get("csv.python") == 1
    _same(t, htj.load_csv(path))


def test_byte_ranges_partition_the_rows(tmp_path):
    """The split-0 load across ranks parses byte ranges: ranges that
    partition the file own disjoint rows that cover it, in the native
    parser and in the Python range parser alike."""
    path = str(tmp_path / "r.csv")
    htt.save_csv(htt.array(DATA), path)
    size = os.path.getsize(path)
    for parts in (1, 2, 3, 5, 40):
        per = -(-size // parts)
        nat = [native.csv_parse_range(path, p * per, per, 0, ",", np.float32) for p in range(parts)]
        py = [htt.io._py_csv_range(path, p * per, per, 0, ",", "utf-8").astype(np.float32) for p in range(parts)]
        got = np.concatenate([a.reshape(-1, 5) for a in nat])
        np.testing.assert_array_equal(got, np.concatenate([a.reshape(-1, 5) for a in py]))
        np.testing.assert_array_equal(got, np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_an_injected_commit_fault_leaves_no_partial_file(tmp_path, fmt):
    ext, args, kwargs = FORMATS[fmt]
    path = tmp_path / f"c{ext}"
    htt.save(htt.array(DATA), str(path), *args, **kwargs)
    before = path.read_bytes()

    def fail_commit(name, ctx):
        if name == "io.commit":
            raise OSError("injected commit failure")

    _hooks.set_injector(fail_commit)
    with pytest.raises(OSError, match="injected"):
        htt.save(htt.array(DATA * 2), str(path), *args, **kwargs)
    _hooks.set_injector(None)
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == [path.name]  # no temp file left behind
    with pytest.raises(OSError, match="injected"):
        _hooks.set_injector(fail_commit)
        htt.save(htt.array(DATA), str(tmp_path / f"new{ext}"), *args, **kwargs)
    assert not (tmp_path / f"new{ext}").exists()


def test_retry_policy_reruns_a_transient_failure(tmp_path):
    path = str(tmp_path / "r.h5")
    htt.save(htt.array(DATA), path, "data")
    calls = []

    def flaky(name, ctx):
        if name == "io.open":
            calls.append(name)
            if len(calls) <= 2:
                raise OSError("transient")

    from heat_tpu_torch.core._retry import RetryError, RetryPolicy

    _hooks.set_injector(flaky)
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, seed=1, sleep=lambda s: None)
    np.testing.assert_array_equal(htt.load(path, "data", retry=policy).numpy(), DATA)
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(RetryError) as info:
        htt.load(path, "data", retry=RetryPolicy(max_attempts=2, base_delay=0.0, sleep=lambda s: None))
    assert len(info.value.attempts) == 2 and isinstance(info.value, OSError)
    assert RetryPolicy(max_attempts=4, seed=3).delays() == __import__(
        "heat_tpu.core._retry", fromlist=["RetryPolicy"]).RetryPolicy(max_attempts=4, seed=3).delays()


def test_a_missing_file_raises_file_not_found_in_both(tmp_path):
    for pkg in (htt, htj):
        for name in ("nope.h5", "nope.nc", "nope.csv"):
            with pytest.raises(FileNotFoundError):
                pkg.load(str(tmp_path / name), "x") if not name.endswith(".csv") else pkg.load(str(tmp_path / name))
        with pytest.raises(ValueError):
            pkg.load(__file__)
    assert htt.supports_hdf5() == htj.supports_hdf5() and htt.supports_netcdf() == htj.supports_netcdf()


def test_netcdf4_model_files_load_in_both(tmp_path):
    """format='NETCDF4' without the netCDF4 library: an HDF5 file with a
    dimension scale per axis, written by either package."""
    for w, r in ((htt, htj), (htj, htt)):
        path = str(tmp_path / f"{w.__name__}.nc")
        w.save(w.array(DATA), path, "v")
        _same(*((w.load(path, "v", split=0), r.load(path, "v", split=0))[:: 1 if w is htt else -1]))
        with pytest.raises(KeyError):
            r.load(path, "dim_0")


def test_classic_size_limits_follow_the_format():
    """CDF-1 holds a variable of at most 2^31 - 4 bytes, CDF-2 one of at
    most 2^32 - 4 (the header's vsize is an unsigned 32-bit field)."""
    _netcdf3.netcdf3_header("x", (2**24, 32), np.float32, version=2)  # 2 GiB: fits CDF-2
    with pytest.raises(ValueError, match="CDF-1"):
        _netcdf3.netcdf3_header("x", (2**24, 32), np.float32, version=1)
    with pytest.raises(ValueError, match="CDF-2"):
        _netcdf3.netcdf3_header("x", (2**30,), np.float32, version=2)


def test_a_vsize_past_2_gib_reads_in_both(tmp_path):
    """A variable of 2 GiB or more has a vsize with the top bit set; the
    port writes it unsigned. heat_tpu's reader ignores a fixed variable's
    vsize, so it reads such files too: a small file with that bit patched
    in stands for a large one."""
    path = str(tmp_path / "big.nc")
    _netcdf3.write_netcdf3(path, "x", DATA, version=2)
    raw = bytearray(open(path, "rb").read())
    head = _netcdf3.netcdf3_header("x", DATA.shape, DATA.dtype, 2)[0]
    vsize_at = len(head) - 8 - 4  # the begin offset (8 bytes) follows the vsize
    assert int.from_bytes(raw[vsize_at:vsize_at + 4], "big") == DATA.nbytes
    raw[vsize_at:vsize_at + 4] = (2**31).to_bytes(4, "big")
    open(path, "wb").write(bytes(raw))
    assert _netcdf3.NetCDF3File(path).vars["x"].vsize == 2**31
    np.testing.assert_array_equal(ref_nc3.NetCDF3File(path).read("x", 3, 7), DATA[3:7])
    np.testing.assert_array_equal(_netcdf3.NetCDF3File(path).read("x", 3, 7), DATA[3:7])
