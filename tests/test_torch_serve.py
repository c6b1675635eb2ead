"""heat_tpu_torch.serve against heat_tpu.serve, on the CPU: the replicated
tick's frame codec and plan function (bit for bit on the same frames), the
bucket policy and plan batches, the autoscaler's verdicts, a service of a
KMeans and a kNN classifier carried over by ``convert`` playing the same
trace (rows and SERVE_STATS counters equal), the fault ladder under the
same fault schedule, admission control, registry snapshots restored both
ways, and ``feed``.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does; its dispatcher thread sees that communicator too (``comm_context`` is
process-global). The service plays its trace in barrier mode: the latency
trigger is off (``max_latency_ms`` 1e7), so batches form by the count
trigger and ``flush`` alone, greedy prefixes of each endpoint's requests,
whatever the threads' timing. Every row is compared exactly (labels), as
are the counters; every service is closed in ``finally``, every
``result()`` has a timeout, and retry sleeps are stubbed.
"""
import threading

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, MeshCommunication, comm_context
from heat_tpu.serve import tick as tick_j

import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.serve import tick as tick_t

TIMEOUT = 60
COUNTERS = ("requests", "batches", "batched_rows", "padded_rows", "bucket_hits", "bucket_misses", "errors", "retries",
            "bisections", "restores", "shrinks", "redispatched", "shed", "rejected")
_rng = np.random.default_rng(2033)
TRAIN = np.concatenate([_rng.normal(size=(60, 4)) + c for c in ((6, 0, 0, 0), (0, 6, 0, 0), (0, 0, 6, 0))])
TRAIN = TRAIN.astype(np.float32)
_rng.shuffle(TRAIN)
TRACE = [("km.predict" if i % 4 == 0 else "knn.predict", _rng.normal(size=(int(n), 4)).astype(np.float32) * 4)
         for i, n in enumerate(_rng.integers(1, 7, size=24))]


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def nosleep(pkg, attempts=3):
    return pkg.resilience.RetryPolicy(max_attempts=attempts, base_delay=0.001, jitter=0.0, seed=0,
                                      sleep=lambda s: None)


def _delta(pkg, before):
    return {k: pkg.serve.SERVE_STATS[k] - before[k] for k in COUNTERS}


# ----------------------------------------------------------------- the tick
def _random_frame(rng, nproc):
    """One rank's plausible queue view, from a seed."""
    tokens = [tick_j.bucket_token(("ep%d" % i, (4,), "<f4")) for i in range(20)]
    frames = []
    seq = int(rng.integers(0, 200))
    for r in range(nproc):
        nb = int(rng.integers(0, 20))
        buckets = [(tokens[i], int(rng.integers(0, 6)), int(rng.integers(0, 90)), int(rng.integers(0, 5000)),
                    int(rng.integers(0, seq + 1))) for i in rng.choice(20, size=nb, replace=False)]
        kw = dict(seq=seq + int(rng.integers(0, 3)), closed=bool(rng.random() < 0.2), qlen=int(rng.integers(0, 30)),
                  npending=int(rng.integers(0, 30)), have_call=bool(rng.random() < 0.3), buckets=buckets,
                  shed=[int(s) for s in rng.integers(0, seq + 3, size=int(rng.integers(0, 40)))])
        if rng.random() < 0.5:
            kw.update(mon_due=bool(rng.random() < 0.8), mon_failed=[int(d) for d in rng.integers(0, 8, size=2)],
                      mon_ewmas_us=[(int(d), int(rng.integers(0, 90000))) for d in range(4)],
                      votes=(bool(rng.random() < 0.5), bool(rng.random() < 0.5)))
        frames.append((kw, tick_j.encode_frame(**kw)))
    return frames


@pytest.mark.parametrize("seed", range(12))
def test_encode_frame_and_plan_dispatch_equal_heat_tpus_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    frames = _random_frame(rng, int(rng.integers(1, 5)))
    ours = np.stack([tick_t.encode_frame(**kw) for kw, _ in frames])
    theirs = np.stack([f for _, f in frames])
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    for max_batch, max_lat in ((8, 1000), (32, 2000), (1, 0)):
        pt = tick_t.plan_dispatch(ours, max_batch_rows=max_batch, max_latency_us=max_lat)
        pj = tick_j.plan_dispatch(theirs, max_batch_rows=max_batch, max_latency_us=max_lat)
        assert [getattr(pt, f) for f in pj.__dataclass_fields__] == [getattr(pj, f) for f in pj.__dataclass_fields__]
    assert (tick_t.FRAME_WIDTH, tick_t.BUCKET_CAP, tick_t.SHED_CAP) == (tick_j.FRAME_WIDTH, tick_j.BUCKET_CAP,
                                                                      tick_j.SHED_CAP)


def test_bucket_token_is_heat_tpus():
    for key in [("knn.predict", (32,), "<f4"), ("km.predict", (), "<i8"), ("x", (3, 4), "|b1"), ("", (0,), "<f8")]:
        assert tick_t.bucket_token(key) == tick_j.bucket_token(key)
    with pytest.raises(ValueError):
        tick_t.plan_dispatch(np.zeros((2, 5), np.int64), max_batch_rows=1, max_latency_us=1)


# -------------------------------------------------------------- batching
def test_bucket_policy_and_plan_batches_match_heat_tpu():
    from heat_tpu.serve.batching import form_plan_batches as fj
    from heat_tpu_torch.serve.batching import form_plan_batches as ft

    for edges, mb in (((1, 2, 4, 8, 16, 32, 64, 128, 256), 256), ((1, 3, 10), 10), ((4,), 4)):
        pj, pt = htj.serve.BucketPolicy(edges, max_batch=mb), htt.serve.BucketPolicy(edges, max_batch=mb)
        for rows in (1, 2, 3, 4, 5, 9, 10, 11, 33, 257, 1000):
            assert pt.bucket_rows(rows) == pj.bucket_rows(rows)
            a = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
            np.testing.assert_array_equal(pt.pad(a), pj.pad(a))
    for kw in ({"edges": ()}, {"edges": (0, 2)}, {"max_batch": 0}):
        with pytest.raises(ValueError):
            htj.serve.BucketPolicy(**kw)
        with pytest.raises(ValueError):
            htt.serve.BucketPolicy(**kw)

    class R:
        def __init__(self, rows):
            self.rows, self.enqueue_t, self.payload = rows, 0.0, np.zeros((rows, 2), np.float32)

    reqs = [R(int(n)) for n in np.random.default_rng(3).integers(1, 12, size=30)]
    for mb in (1, 8, 16, 64):
        bt, bj = ft("k", reqs, mb), fj("k", reqs, mb)
        assert [[id(r) for r in b.requests] for b in bt] == [[id(r) for r in b.requests] for b in bj]
        assert [b.rows for b in bt] == [b.rows for b in bj]
        np.testing.assert_array_equal(bt[0].stack(htt.serve.BucketPolicy(max_batch=mb)),
                                      bj[0].stack(htj.serve.BucketPolicy(max_batch=mb)))


# ------------------------------------------------------------ autoscaler
class _Report:
    def __init__(self, degraded=(), healed=()):
        self.degraded, self.healed = list(degraded), list(healed)


@pytest.mark.parametrize("cooldown", [0.0, 5.0])
def test_autoscaler_verdicts_match_heat_tpu(cooldown):
    """pre_vote/vote/resolve on the same depth and report sequence, with an
    injected clock, and capacity below the four-device base while device 2
    is marked: the same verdicts, streaks and deferred heals."""
    import jax

    now = [0.0]
    seq = [(0, _Report()), (12, _Report()), (12, _Report()), (20, _Report(degraded=[1])), (9, _Report()),
           (10, _Report()), (1, _Report(healed=[2])), (30, _Report()), (30, _Report()), (0, _Report()),
           (11, _Report(healed=[3])), (11, _Report())]
    out = []
    for pkg, base in ((htj, MeshCommunication(devices=jax.devices()[:4])), (htt, TorchCommunication(ranks=[0, 1, 2, 3]))):
        mon = pkg.resilience.HealthMonitor(base, interval_s=0.0)
        a = pkg.serve.Autoscaler(mon, high_depth=8, low_depth=2, hysteresis=2, cooldown_s=cooldown,
                                 clock=lambda: now[0])
        verdicts = []
        for t, (depth, rep) in enumerate(seq):
            now[0] = float(t)
            if t == 5:
                pkg.resilience.mark_unhealthy(2)
            want = a.vote(depth, rep)
            verdicts.append((want, a.resolve(want, rep), a._pressure, a._deferred_heal))
        pkg.resilience.clear_unhealthy()
        out.append(verdicts)
    assert out[1] == out[0]
    assert any(v[1] == "grow" for v in out[0]) and any(v[1] == "shrink" for v in out[0])


# --------------------------------------------------------------- service
def _models(pkg):
    """A KMeans and a kNN classifier fitted by heat_tpu, carried into the
    port through convert (heat_tpu's own for heat_tpu)."""
    x = htj.array(TRAIN, split=0)
    km = htj.cluster.KMeans(3, init=htj.array(TRAIN[:3]), max_iter=6, tol=None).fit(x)
    knn_x, knn_y = TRAIN, np.asarray(km.labels_.numpy())
    if pkg is htj:
        return km, htj.classification.KNeighborsClassifier(3).fit(htj.array(knn_x), htj.array(knn_y))
    return (htt.convert.from_heat_tpu_state(km.state_dict()),
            htt.convert.knn_from_heat_tpu(knn_x, knn_y, n_neighbors=3))


def _play(pkg, trace, faults=(), endpoints=None, snapshot_dir=None, models=True, **svc_kw):
    """The trace through one service in barrier mode (with the KMeans and
    kNN models registered, or ``endpoints`` alone); returns each request's
    answer (rows, or the error's type), the answer counts, the counters'
    deltas and the fault records."""
    before = dict(pkg.serve.SERVE_STATS)
    svc = pkg.serve.ServeService(pkg.serve.BucketPolicy(max_batch=8, max_latency_ms=1e7), retry=nosleep(pkg),
                                 snapshot_dir=snapshot_dir, snapshot_every=1 if snapshot_dir else 0, **svc_kw)
    try:
        if models:
            km, knn = _models(pkg)
            svc.register_model("km", km)
            svc.register_model("knn", knn)
        for name, fn in (endpoints or {}).items():
            svc.register_endpoint(name, fn)
        with pkg.resilience.FaultSchedule(list(faults)) as fs:
            reqs = [svc.submit(ep, p) for ep, p in trace]
            svc.flush()
            svc.drain(timeout=TIMEOUT)
        answers = []
        for r in reqs:
            try:
                answers.append(np.asarray(r.result(timeout=TIMEOUT)))
            except Exception as e:  # noqa: BLE001 - compared by type
                answers.append(type(e).__name__)
    finally:
        svc.close(timeout=TIMEOUT)
    return answers, [r.answers for r in reqs], _delta(pkg, before), [(i.site, i.kind) for i in fs.injected]


def _same(got, want):
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        if isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_barrier_mode_trace_gives_heat_tpus_rows_and_counters():
    got, want = _play(htt, TRACE), _play(htj, TRACE)
    _same(got, want)
    assert got[2]["requests"] == len(TRACE) and got[2]["errors"] == 0 and set(got[1]) == {1}
    km, knn = _models(htt)  # each row is the model's own predict of the request's rows
    for (ep, p), rows in zip(TRACE, got[0]):
        np.testing.assert_array_equal(rows, (km if ep == "km.predict" else knn).predict(htt.array(p)).numpy())


def _flaky(kind):
    """An endpoint that doubles its rows, raising ``kind`` on its second
    call (after a good batch, so a snapshot exists) and ValueError on any
    batch holding the poison value -999."""
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        host = x.numpy()
        if (host == -999).any():
            raise ValueError("poison row")
        if kind is not None and calls["n"] == 2:
            raise kind("second call fails")
        return x * 2

    return fn


LADDER = {
    # two transient I/O faults at the dispatch site: retried in place
    "retry": dict(faults=[("serve.dispatch", 2, "io_error"), ("serve.dispatch", 3, "io_error")]),
    # three: the retries run out and the batch is bisected (every half then succeeds)
    "exhausted": dict(faults=[("serve.dispatch", 1, "io_error"), ("serve.dispatch", 2, "io_error"),
                              ("serve.dispatch", 3, "io_error")]),
    # a poison request among neighbours: isolated by bisection
    "poison": dict(poison=True),
    # resident state suspect: the registry is restored from its snapshot and the batch replayed
    "restore": dict(kind="DivergenceError", snapshot=True),
    # a runtime error whose probe finds the card healthy: bisected
    "probe": dict(kind=RuntimeError),
    # a device loss cannot fire on one card: stays pending
    "device_loss": dict(faults=[("serve.dispatch", 1, "device_loss")]),
}


@pytest.mark.parametrize("rung", sorted(LADDER))
def test_fault_ladder_matches_heat_tpu(rung, tmp_path):
    spec = LADDER[rung]
    rng = np.random.default_rng(11)
    trace = [("f.echo", rng.normal(size=(int(n), 4)).astype(np.float32)) for n in rng.integers(1, 5, size=9)]
    trace[4] = ("f.echo", np.full((2, 4), -999, np.float32)) if spec.get("poison") else trace[4]
    results = []
    for pkg in (htt, htj):
        kind = spec.get("kind")
        if kind == "DivergenceError":
            kind = pkg.resilience.DivergenceError
        results.append(_play(pkg, trace, spec.get("faults", ()), {"f.echo": _flaky(kind)},
                             str(tmp_path / pkg.__name__) if spec.get("snapshot") else None, models=rung == "restore"))
    _same(results[0], results[1])
    answers, counts, stats, _ = results[0]
    assert set(counts) == {1}, counts
    want = {"retry": {"retries": 2}, "exhausted": {"retries": 2, "bisections": 1},
            "poison": {"bisections": 1}, "restore": {"restores": 1},
            "probe": {"bisections": 1}, "device_loss": {}}[rung]
    assert {k: stats[k] for k in want} == want, stats
    for (ep, p), a in zip(trace, answers):
        if ep == "f.echo" and not (p == -999).any():
            np.testing.assert_array_equal(a, p * 2)
    if rung == "poison":
        assert answers[4] == "PoisonRequestError"
    if rung == "restore":
        assert stats["redispatched"] >= 1


def _blocked(pkg, fn):
    """``fn(svc)`` while the dispatcher is inside a control call."""
    gate, running = threading.Event(), threading.Event()

    def block():
        running.set()
        gate.wait(TIMEOUT)

    before = dict(pkg.serve.SERVE_STATS)
    svc = pkg.serve.ServeService(pkg.serve.BucketPolicy(edges=(1, 2), max_batch=2), max_queue_depth=2)
    try:
        svc.register_endpoint("id", lambda x: x)
        blocker = svc.submit_call(block)
        assert running.wait(TIMEOUT)
        try:
            out = fn(svc)
        finally:
            gate.set()
        blocker.result(TIMEOUT)
        svc.drain(TIMEOUT)
        answers = []
        for r in out:
            try:
                answers.append(np.asarray(r.result(TIMEOUT)))
            except Exception as e:  # noqa: BLE001 - compared by type
                answers.append(type(e).__name__)
    finally:
        svc.close(TIMEOUT)
    return answers, [r.answers for r in out], _delta(pkg, before)


def test_admission_rejects_past_the_high_water_and_sheds_expired_deadlines():
    results = []
    for pkg in (htt, htj):
        def submits(svc, pkg=pkg):
            ok = [svc.submit("id", np.ones((1, 2), np.float32)), svc.submit("id", np.ones((1, 2), np.float32),
                                                                            deadline_ms=0.0)]
            with pytest.raises(pkg.resilience.ServeOverloadError, match="back off"):
                svc.submit("id", np.ones((1, 2), np.float32))
            return ok

        results.append(_blocked(pkg, submits))
    _same(results[0], results[1])
    answers, counts, stats = results[0]
    assert answers[1] == "ServeDeadlineError" and counts == [1, 1]
    assert (stats["rejected"], stats["shed"], stats["requests"]) == (1, 1, 2)


def test_submit_validation_and_closed_service():
    svc = htt.serve.ServeService()
    try:
        svc.register_endpoint("id", lambda x: x)
        with pytest.raises(KeyError):
            svc.submit("nope", np.ones((1, 2)))
        with pytest.raises(ValueError):
            svc.submit("id", np.ones((0, 2)))
        with pytest.raises(ValueError):
            htt.serve.ServeService(max_queue_depth=0)
        with pytest.raises(TypeError):
            svc.register_model("m", object())
    finally:
        svc.close(TIMEOUT)
    with pytest.raises(RuntimeError):
        svc.submit("id", np.ones((1, 2)))


@pytest.mark.parametrize("writer,reader", [(htj, htt), (htt, htj)], ids=["heat_tpu_to_port", "port_to_heat_tpu"])
def test_registry_snapshot_restores_in_the_other_package(writer, reader, tmp_path):
    """A snapshot of a KMeans, a Lasso and a kNN classifier (skipped: no
    state_dict) restores into the other package's registry of differently
    fitted models."""
    rng = np.random.default_rng(5)
    X = np.c_[np.ones(50), rng.normal(size=(50, 3))].astype(np.float32)
    y = (X @ np.array([1.0, 2.0, 0.0, -1.0])).astype(np.float32)

    def registry(pkg, k0):
        reg = pkg.serve.ModelRegistry()
        x = pkg.array(TRAIN, split=0)
        reg.register("km", pkg.cluster.KMeans(3, init=pkg.array(TRAIN[k0:k0 + 3]), max_iter=4, tol=None).fit(x))
        reg.register("lasso", pkg.regression.Lasso(lam=0.01 * (k0 + 1), max_iter=20).fit(pkg.array(X, split=0),
                                                                                      pkg.array(y, split=0)))
        reg.register("knn", pkg.classification.KNeighborsClassifier(3).fit(x, pkg.array(np.zeros(len(TRAIN),
                                                                                                  np.int64))))
        return reg

    src, dst = registry(writer, 0), registry(reader, 7)
    src.snapshot(str(tmp_path))
    assert dst.restore(str(tmp_path)) == ["km", "lasso"]
    for name, attr in (("km", "cluster_centers_"), ("lasso", "theta")):
        np.testing.assert_array_equal(np.asarray(getattr(dst.get(name), attr).numpy()),
                                      np.asarray(getattr(src.get(name), attr).numpy()))
    np.testing.assert_array_equal(np.asarray(dst.get("km").labels_.numpy()), np.asarray(src.get("km").labels_.numpy()))
    assert dst.restore(str(tmp_path), names=["lasso"]) == ["lasso"]


def test_feed_streams_partial_fit_like_heat_tpu():
    rng = np.random.default_rng(9)
    chunks = [(np.c_[np.ones(20), rng.normal(size=(20, 3))].astype(np.float32),
               rng.normal(size=20).astype(np.float32)) for _ in range(5)]
    thetas = []
    for pkg in (htt, htj):
        svc = pkg.serve.ServeService()
        try:
            svc.registry.register("lasso", pkg.regression.Lasso(lam=0.01))
            n = svc.feed("lasso", ((pkg.array(a, split=0), pkg.array(b, split=0)) for a, b in chunks),
                         timeout=TIMEOUT)
            thetas.append((n, np.asarray(svc.registry.get("lasso").theta.numpy())))
        finally:
            svc.close(TIMEOUT)
    assert thetas[0][0] == thetas[1][0] == 5
    np.testing.assert_allclose(thetas[0][1], thetas[1][1], rtol=1e-5, atol=1e-6)


def test_tick_mode_at_world_size_1_serves_every_request_once():
    """tick_ms > 0 arms the replicated tick in one process (its collectives
    pass through): every request is answered once with the models' rows, and
    every batch was dispatched by a tick plan."""
    km, knn = _models(htt)
    before = dict(htt.serve.SERVE_STATS)
    svc = htt.serve.ServeService(htt.serve.BucketPolicy(max_batch=8, max_latency_ms=1.0), tick_ms=1.0,
                                 autoscaler=htt.serve.Autoscaler(htt.resilience.HealthMonitor(interval_s=0.0)))
    try:
        svc.register_model("km", km)
        svc.register_model("knn", knn)
        reqs = [svc.submit(ep, p) for ep, p in TRACE]
        svc.drain(TIMEOUT)
        for (ep, p), r in zip(TRACE, reqs):
            np.testing.assert_array_equal(r.result(TIMEOUT), (km if ep == "km.predict" else knn).predict(
                htt.array(p)).numpy())
    finally:
        svc.close(TIMEOUT)
    stats = {k: htt.serve.SERVE_STATS[k] - before[k] for k in ("batches", "tick_batches", "requests", "scale_events")}
    assert stats["batches"] == stats["tick_batches"] > 0 and stats["requests"] == len(TRACE)
    assert stats["scale_events"] == 0 and all(r.answers == 1 for r in reqs)
