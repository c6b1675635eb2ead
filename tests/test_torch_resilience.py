"""heat_tpu_torch.resilience against heat_tpu's, on the CPU: the error
classes, ``validate``/``DNDarray.health_check``, checkpoints both ways
(each package loads the other's, with byte-equal shard files), corruption
and torn writes under chaos, retry exhaustion, ``FaultSchedule``
determinism, the watchdog against a straggler, and guard digests.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does, on the same numpy inputs from seeds. Everything compared here is
exact: shard bytes, manifests (but the fields naming the writer's mesh and
processes), loaded values, digests, fault streams and messages.
``heat_tpu`` cannot load a bfloat16 checkpoint, its own neither (Queue C,
C7 in ``ROADMAP.md``): that direction is held by byte-equal shards.
"""
import json
import os
import time

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

rzt, rzj = htt.resilience, htj.resilience
_rng = np.random.default_rng(2029)
ARRAYS = {
    "f32": _rng.normal(size=(11, 4)).astype(np.float32),
    "i64": _rng.integers(-9, 9, size=(7, 3)).astype(np.int64),
    "bool": _rng.integers(0, 2, size=(9,)).astype(bool),
    "c64": (_rng.normal(size=(5, 2)) + 1j * _rng.normal(size=(5, 2))).astype(np.complex64),
    "u8": _rng.integers(0, 255, size=(6, 5)).astype(np.uint8),
}


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d)) if n.startswith("shard_")}


def _manifest(d):
    m = json.load(open(os.path.join(d, "manifest.json")))
    m.pop("mesh")
    return m


# ------------------------------------------------------------------- errors
def test_error_classes_messages_and_fields_match_heat_tpu():
    from heat_tpu.resilience import errors as je
    from heat_tpu_torch.resilience import errors as te

    assert sorted(je.__all__) == sorted(te.__all__)
    cases = [
        ("DivergenceError", ("m",), {"devices": [2], "groups": [(0, ((0, "a"),))], "label": "x"}),
        ("CollectiveTimeout", ("flatmove.ragged", 1.5, 1.0, "detail"), {}),
        ("CollectiveTimeout", ("collective.allgather", 0.1, 2.0), {}),
        ("LockstepError", ("m",), {"seq": 3, "site": "collective.allgather", "process_index": 1, "counts": [2, 3]}),
        ("NoHealthyDevicesError", (4,), {}),
        ("ServeOverloadError", (9, 8), {}),
        ("ServeDeadlineError", ("ep", 12.5, 10.0), {}),
        ("PoisonRequestError", ("ep", ValueError("bad")), {}),
        ("DegradeError", ("m",), {}),
        ("ResilienceError", ("m",), {}),
    ]
    for name, args, kw in cases:
        t, j = getattr(te, name)(*args, **kw), getattr(je, name)(*args, **kw)
        assert str(t) == str(j), name
        assert {k: v for k, v in vars(t).items() if k != "__cause__"} == \
            {k: v for k, v in vars(j).items() if k != "__cause__"}, name
        assert [c.__name__ for c in type(t).__mro__] == [c.__name__ for c in type(j).__mro__], name
    assert isinstance(rzt.ValidationError(["a"]), ValueError) and str(rzt.ValidationError(["a", "b"])) == \
        str(rzj.ValidationError(["a", "b"]))
    assert issubclass(rzt.CheckpointCorruptionError, rzt.CheckpointError)
    assert rzt.RetryPolicy is htt.core._retry.RetryPolicy
    assert vars(rzt.DEFAULT_CHECKPOINT_POLICY).keys() == vars(rzj.DEFAULT_CHECKPOINT_POLICY).keys()
    for k in ("max_attempts", "base_delay", "max_delay", "multiplier", "jitter", "seed", "max_elapsed"):
        assert getattr(rzt.DEFAULT_CHECKPOINT_POLICY, k) == getattr(rzj.DEFAULT_CHECKPOINT_POLICY, k)
    assert rzt.DEFAULT_CHECKPOINT_POLICY.delays() == rzj.DEFAULT_CHECKPOINT_POLICY.delays()


# ------------------------------------------------------------------ validate
@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("split", [None, 0])
def test_validate_and_health_check_pass_on_healthy_arrays(name, split):
    x = htt.array(ARRAYS[name], split=split)
    assert x.health_check() is x and rzt.validate(x, check_values=True) is x
    j = htj.array(ARRAYS[name], split=split)
    assert j.health_check(check_values=True) is j


def test_validate_names_every_broken_invariant():
    x = htt.array(ARRAYS["f32"], split=0)
    x._DNDarray__array = x._raw[:5].double()  # a torn shard of the wrong type
    with pytest.raises(rzt.ValidationError) as e:
        x.health_check()
    assert len(e.value.problems) == 2
    assert "tensor shape (5, 4) != its lshape_map row (11, 4)" in e.value.problems[0]
    assert "does not match annotation float32" in e.value.problems[1]
    r = htt.array(ARRAYS["f32"], split=0)
    r.redistribute_(target_map=np.asarray([[11, 4]]))
    assert r.health_check() is r


def test_check_values_counts_non_finite_values_as_heat_tpu_does():
    a = ARRAYS["f32"].copy()
    a[1, 2], a[4, 0], a[9, 3] = np.nan, np.inf, -np.inf
    msgs = []
    for ht, rz in ((htt, rzt), (htj, rzj)):
        x = ht.array(a, split=0)
        assert x.health_check() is x  # values are not scanned unless asked
        with pytest.raises(rz.ValidationError) as e:
            x.health_check(check_values=True)
        msgs.append(e.value.problems)
    assert msgs[0] == msgs[1] == ["3 non-finite value(s) (NaN/Inf) in the logical array"]
    assert htt.array(ARRAYS["i64"]).health_check(check_values=True) is not None  # exact types are not scanned


# --------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("checksum", ["crc32", "sha256"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_checkpoints_load_across_packages_with_byte_equal_shards(tmp_path, name, split, checksum):
    a = ARRAYS[name]
    if split == 1 and a.ndim < 2:
        split = 0
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    rzt.save_checkpoint(htt.array(a, split=split), dt, checksum=checksum)
    rzj.save_checkpoint(htj.array(a, split=split), dj, checksum=checksum)
    assert _files(dt) == _files(dj)
    assert _manifest(dt) == _manifest(dj)
    mt = json.load(open(os.path.join(dt, "manifest.json")))["mesh"]
    assert mt == {"axis_sizes": {"split": 1}, "split_size": 1, "processes": 1}
    for load, d in ((rzt.load_checkpoint, dj), (rzj.load_checkpoint, dt), (rzt.load_checkpoint, dt)):
        y = load(d)
        assert y.split == split and tuple(y.gshape) == a.shape and y.dtype.__name__ == a.dtype.name
        np.testing.assert_array_equal(np.asarray(y.numpy()), a)


def test_bfloat16_and_ragged_checkpoints_match_heat_tpu(tmp_path):
    a = ARRAYS["f32"]
    x = htt.array(a, split=0, dtype=htt.bfloat16)
    rzt.save_checkpoint(x, str(tmp_path / "t"))
    rzj.save_checkpoint(htj.array(a, split=0, dtype=htj.bfloat16), str(tmp_path / "j"))
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert _manifest(str(tmp_path / "t"))["dtype"] == "bfloat16"
    y = rzt.load_checkpoint(str(tmp_path / "j"))
    assert y.dtype is htt.bfloat16
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    # heat_tpu loads no bfloat16 checkpoint, its own neither: numpy finds no cast from the '<V2' shard to
    # ml_dtypes' bfloat16 (ROADMAP.md, Queue C, C7); the shards above are the same bytes
    with pytest.raises(ValueError, match="No cast function"):
        rzj.load_checkpoint(str(tmp_path / "j"))
    f = htt.Frame({"k": np.arange(11, dtype=np.int32), "x": a[:, 0]})
    g = f.filter(f["x"] > 0)["x"]  # a ragged column
    rzt.save_checkpoint(g, str(tmp_path / "r"))
    np.testing.assert_array_equal(rzj.load_checkpoint(str(tmp_path / "r")).numpy(), a[a[:, 0] > 0, 0])


def test_resave_collects_stale_shards_and_errors(tmp_path):
    d = str(tmp_path / "c")
    rzt.save_checkpoint(htt.array(ARRAYS["f32"], split=0), d)
    rzt.save_checkpoint(htt.array(ARRAYS["f32"][:3], split=None), d)
    assert sorted(os.listdir(d)) == ["manifest.json", "shard_000000000000.npy"]
    with pytest.raises(FileNotFoundError):
        rzt.load_checkpoint(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="unknown checksum"):
        rzt.save_checkpoint(htt.array(ARRAYS["f32"]), d, checksum="md5")
    m = json.load(open(os.path.join(d, "manifest.json")))
    m["format"] = "other"
    open(os.path.join(d, "manifest.json"), "w").write(json.dumps(m))
    with pytest.raises(rzt.CheckpointError, match="unsupported checkpoint format"):
        rzt.read_manifest(d)


@pytest.mark.parametrize("checksum", ["crc32", "sha256"])
def test_corrupted_shard_raises_naming_the_file(tmp_path, checksum):
    for rz, ht in ((rzt, htt), (rzj, htj)):
        d = str(tmp_path / ht.__name__)
        with rz.chaos(seed=1, corrupt=1.0, max_faults=1, targets=("io",)) as c:
            rz.save_checkpoint(ht.array(ARRAYS["f32"], split=0), d, checksum=checksum)
        assert [i.kind for i in c.injected] == ["corrupt"]
        with pytest.raises(rz.CheckpointCorruptionError, match="shard_000000000000.npy") as e:
            rz.load_checkpoint(d)
        assert f"failed {checksum} verification" in str(e.value)
        rz.load_checkpoint(d, verify=False)  # the flipped byte is past the header: the file still parses


def test_torn_writes_recover_under_the_checkpoint_policy_and_retries_exhaust(tmp_path):
    streams = []
    for rz, ht in ((rzt, htt), (rzj, htj)):
        d = str(tmp_path / ht.__name__)
        with rz.chaos(seed=0, torn_write=1.0, max_faults=2) as c:
            rz.save_checkpoint(ht.array(ARRAYS["f32"], split=0), d)
        streams.append([(i.site, i.kind, i.detail) for i in c.injected])
        np.testing.assert_array_equal(np.asarray(rz.load_checkpoint(d).numpy()), ARRAYS["f32"])
        assert not [n for n in os.listdir(d) if ".tmp-" in n]
        with rz.chaos(seed=0, io_error=1.0, targets=("checkpoint",)):
            with pytest.raises(rz.RetryError) as e:
                rz.save_checkpoint(ht.array(ARRAYS["f32"], split=0), d)
        assert len(e.value.attempts) == 3
    assert streams[0] == streams[1] and [k for _, k, _ in streams[0]] == ["torn_write", "torn_write"]


def test_fault_schedule_and_chaos_streams_are_deterministic_and_match_heat_tpu(tmp_path):
    def run(rz, ht, tag):
        with rz.chaos(seed=7, io_error=0.3, corrupt=0.2, torn_write=0.2) as c:
            try:
                rz.save_checkpoint(ht.array(ARRAYS["f32"], split=0), str(tmp_path / tag))
            except OSError:
                pass
        return [(i.site, i.kind, i.detail) for i in c.injected], c.draws

    t1, t2, j1 = run(rzt, htt, "a"), run(rzt, htt, "b"), run(rzj, htj, "c")
    assert t1 == t2 == j1 and t1[0]
    events = [("io.write", 1, "torn_write"), ("checkpoint.shard", 2, "io_error"), ("guard.shard", 1, "divergence")]
    got = []
    for _ in range(2):
        with rzt.FaultSchedule(events) as fs:
            rzt.save_checkpoint(htt.array(ARRAYS["f32"], split=0), str(tmp_path / "s"))
            rzt.fingerprint(htt.array(ARRAYS["f32"]))  # the primary replica: the divergence stays pending
        got.append(([(i.site, i.kind, i.detail) for i in fs.injected], fs.pending(), fs.report()))
    assert got[0] == got[1]
    assert [k for _, k, _ in got[0][0]] == ["torn_write", "io_error"] and got[0][1] == [events[2]]
    with pytest.raises(ValueError):
        rzt.FaultSchedule([("io.write", 0, "io_error")])
    with pytest.raises(ValueError):
        rzt.chaos(io_error=2.0)
    with pytest.raises(ValueError):
        rzt.chaos(targets=("nowhere",))


# ------------------------------------------------------------------ watchdog
def test_watchdog_bounds_a_straggler_and_upgrades_timeouts():
    slow = rzt.with_deadline(lambda: time.sleep(1.0), 0.1, "collective.allgather")
    t0 = time.monotonic()
    with pytest.raises(rzt.CollectiveTimeout) as e:
        slow()
    assert time.monotonic() - t0 < 0.9 and e.value.label == "collective.allgather" and e.value.deadline == 0.1
    assert rzt.with_deadline(lambda a, b=1: a + b, 1.0)(2, b=3) == 5
    with pytest.raises(ValueError):
        rzt.with_deadline(lambda: 0, 0)
    f = htt.Frame({"k": np.arange(40, dtype=np.int32) % 7, "x": np.ones(40, np.float32)})
    assert rzt.watchdog.current_deadline() is None
    with rzt.deadlines(0.2):
        assert rzt.watchdog.current_deadline() == 0.2
        with rzt.chaos(straggler=1.0, straggler_delay=0.6, targets=("collective",), max_faults=1):
            with pytest.raises(rzt.CollectiveTimeout) as e:
                f.groupby("k").sum()
        assert e.value.label == "flatmove.bucket"
        with rzt.chaos(timeout=1.0, targets=("collective",), max_faults=1):
            with pytest.raises(rzt.CollectiveTimeout, match="injected timeout") as e:
                f.groupby("k").sum()
        np.testing.assert_array_equal(f.groupby("k").sum()["x"].numpy(), np.bincount(np.arange(40) % 7))
    assert rzt.watchdog.current_deadline() is None


# --------------------------------------------------------------------- guard
@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("split", [None, 0])
def test_fingerprints_equal_heat_tpus(name, split):
    t = rzt.fingerprint(htt.array(ARRAYS[name], split=split))
    j = rzj.fingerprint(htj.array(ARRAYS[name], split=split))
    assert (t.gshape, t.dtype, t.split, t.groups) == (j.gshape, j.dtype, j.split, j.groups)


def test_guard_votes_and_boundaries():
    fp = rzt.Fingerprint((4,), "float32", None, ((0, ((0, "aa"), (1, "aa"), (2, "bb"), (3, "aa"))),))
    assert fp.offending_devices() == [2] and len(fp.divergent_groups()) == 1
    tie = rzt.Fingerprint((4,), "float32", None, ((0, ((0, "aa"), (1, "bb"))),))
    assert tie.offending_devices() == [0, 1]
    x, w = htt.array(ARRAYS["f32"], split=0), htt.array(ARRAYS["f32"])
    with rzt.guarded(x, w, check_layout=True, check_values=True) as g:
        y = g.watch(x + w)
        g.check(y)
    assert rzt.check_divergence(x) == rzt.fingerprint(x)
    bad = htt.array(np.asarray([np.nan, 1.0], np.float32))
    with pytest.raises(rzt.ValidationError):
        with rzt.guarded(bad, check_values=True):
            pass
