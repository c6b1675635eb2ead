"""heat_tpu_torch.resilience's supervision and health against heat_tpu's, on
the CPU: the health monitor's ledger transitions, ``CheckpointSchedule``,
the supervised fits of KMeans/KMedians/KMedoids/Lasso (clean and with a
scripted restore), supervisor directories resumed across the packages,
``probe``/``shrink_to_healthy`` at world size 1, and the supervised
``DataParallel.fit``.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does, except where a monitor's base needs four devices: there heat_tpu's
base is ``jax.devices()[:4]`` (ids 0-3) and the port's a communicator of
the four global ranks 0-3 (no group is started; ``apply_gathered`` runs no
collective). Inputs come from numpy seeds. Ledgers, tick reports, counters
and fault records are compared exactly; the supervised fits' centres and
coefficients within rtol 1e-5 / atol 1e-6 (the same float32 iterations,
sums in another order), labels and iteration counts exactly.
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, MeshCommunication, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import TorchCommunication

rzt, rzj = htt.resilience, htj.resilience
RTOL, ATOL = 1e-5, 1e-6
_rng = np.random.default_rng(2031)
BLOBS = np.concatenate([_rng.normal(size=(40, 3)) + c for c in ((8, 0, 0), (0, 8, 0), (0, 0, 8))]).astype(np.float32)
_rng.shuffle(BLOBS)
LASSO_X = np.c_[np.ones(120), _rng.normal(size=(120, 5))].astype(np.float32)
LASSO_Y = (LASSO_X @ np.array([0.5, 2.0, 0.0, -1.0, 0.0, 3.0]) + 0.1 * _rng.normal(size=120)).astype(np.float32)


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        rzt.clear_unhealthy()
        rzj.clear_unhealthy()
        htt.use_device(None)


def nosleep(pkg, attempts=3):
    """A step retry policy whose sleeps are stubbed."""
    return pkg.resilience.RetryPolicy(max_attempts=attempts, base_delay=0.001, seed=0, sleep=lambda s: None)


# ------------------------------------------------------------- the monitor
def _ledger(mon):
    return {d: (e.state, e.ewma_ms, e.streak, e.bad_streak, e.flaps) for d, e in mon.ledger.items()}


def _report(rep):
    return (rep.degraded, rep.healed, rep.flapped, sorted(rep.failed), sorted(rep.stragglers), rep.median_ms)


def _counters(stats):
    return {k: v for k, v in stats.items() if k != "probe_ms_total"}


def _healthy(ms=1.0):
    return {d: ms for d in range(4)}


# each sequence: per tick (the failure union, the gathered EWMAs in ms), as replicated_ids/replicated_frame give them
SEQUENCES = {
    "failure_then_heal": [({2}, {0: 1.0, 1: 1.0, 3: 1.0})] + [(set(), _healthy())] * 3,
    "straggler_degrades": [(set(), {0: 1.0, 1: 1.0, 2: 1.0, 3: 60.0})] * 2 + [(set(), _healthy())] * 4,
    "clean_tick_resets_suspect": [(set(), {0: 1.0, 1: 90.0, 2: 1.0, 3: 1.0}), (set(), _healthy()),
                                  (set(), {0: 1.0, 1: 90.0, 2: 1.0, 3: 1.0})],
    "flap_restarts_streak": [({0}, {1: 1.0, 2: 1.0, 3: 1.0}), (set(), _healthy()), ({0}, {1: 1.0, 2: 1.0, 3: 1.0})]
    + [(set(), _healthy())] * 4,
    "two_fail_one_straggles": [({1, 3}, {0: 2.0, 2: 2.0}), (set(), {0: 2.0, 1: 2.0, 2: 40.0, 3: 2.0}),
                               (set(), {0: 2.0, 1: 2.0, 2: 40.0, 3: 2.0})] + [(set(), _healthy(2.0))] * 4,
    "random": [({int(d) for d in np.nonzero(_rng.random(4) < 0.15)[0]},
                {d: float(np.round(_rng.choice([1.0, 1.5, 30.0, 70.0], p=[0.5, 0.3, 0.1, 0.1]), 3)) for d in range(4)})
               for _ in range(14)],
}


@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_apply_gathered_gives_heat_tpu_ledgers_reports_and_stats(name, external):
    """The same gathered failure/EWMA sequence through both monitors'
    ``apply_gathered`` (heal_after 3, degrade_after 2, factor 8, floor
    5 ms): the same ledger, TickReport and HEALTH_STATS after every tick, and
    the same unhealthy set. ``external`` marks rank 1 unhealthy first, as
    the serve and supervisor ladders do, which the ledger adopts."""
    import jax

    base_j = MeshCommunication(devices=jax.devices()[:4])
    base_t = TorchCommunication(ranks=[0, 1, 2, 3])
    kw = dict(interval_s=0.0, heal_after=3, degrade_after=2, straggler_factor=8.0, floor_ms=5.0)
    mon_j = rzj.HealthMonitor(base_j, **kw)
    mon_t = rzt.HealthMonitor(base_t, **kw)
    rzj.reset_health_stats()
    rzt.reset_health_stats()
    if external:
        rzj.mark_unhealthy(1)
        rzt.mark_unhealthy(1)
    for t, (failed, ewmas) in enumerate(SEQUENCES[name]):
        rj = mon_j.apply_gathered(failed, ewmas, probes=4, failures=len(failed))
        rt = mon_t.apply_gathered(failed, ewmas, probes=4, failures=len(failed))
        assert _report(rt) == _report(rj), (name, t)
        assert _ledger(mon_t) == _ledger(mon_j), (name, t)
        assert _counters(rzt.HEALTH_STATS) == _counters(rzj.HEALTH_STATS), (name, t)
        assert rzt.unhealthy_devices() == rzj.unhealthy_devices(), (name, t)


def test_monitor_validation_matches_heat_tpu():
    for kw in ({"heal_after": 0}, {"degrade_after": 0}, {"ewma_alpha": 0.0}, {"ewma_alpha": 1.5},
               {"straggler_factor": 0.5}):
        with pytest.raises(ValueError):
            rzj.HealthMonitor(**kw)
        with pytest.raises(ValueError):
            rzt.HealthMonitor(**kw)


def test_maybe_tick_cadence_and_flap_at_the_probe_site():
    """An injected clock drives both monitors' cadence the same way, and a
    scheduled ``device_flap`` at ``monitor.probe`` fails the probe once:
    rank/device 0 degrades, then heals after heal_after clean ticks."""
    now = [0.0]
    mons = [pkg.resilience.HealthMonitor(interval_s=10.0, heal_after=2, clock=lambda: now[0]) for pkg in (htj, htt)]
    reports = []
    for pkg, mon in zip((htj, htt), mons):
        pkg.resilience.reset_health_stats()
        out = []
        with pkg.resilience.FaultSchedule([("monitor.probe", 1, "device_flap")]) as fs:
            for t in (0.0, 5.0, 10.0, 12.0, 20.0, 30.0):
                now[0] = t
                rep = mon.maybe_tick()
                out.append(None if rep is None else (rep.degraded, rep.healed, sorted(rep.failed)))
        out.append([(i.site, i.kind, i.detail) for i in fs.injected])
        out.append(_counters(pkg.resilience.HEALTH_STATS))
        out.append({d: e.state for d, e in mon.ledger.items()})
        reports.append(out)
        pkg.resilience.clear_unhealthy()
    assert reports[1] == reports[0]
    assert reports[1][:6] == [([0], [], [0]), None, ([], [], []), None, ([], [0], []), ([], [], [])]


def test_background_thread_ticks_at_world_size_1():
    mon = rzt.HealthMonitor(interval_s=0.01)
    rzt.reset_health_stats()
    try:
        mon.start()
        assert mon.start() is mon
        for _ in range(500):
            if rzt.HEALTH_STATS["ticks"] >= 2:
                break
            __import__("time").sleep(0.01)
    finally:
        mon.stop()
    assert rzt.HEALTH_STATS["ticks"] >= 2 and rzt.HEALTH_STATS["probe_failures"] == 0


# ----------------------------------------------------------- the schedule
@pytest.mark.parametrize("every_steps,every_seconds", [(1, None), (3, None), (None, 0.0), (None, 5.0), (2, 5.0)])
def test_checkpoint_schedule_due_matches_heat_tpu(every_steps, every_seconds):
    sj = rzj.CheckpointSchedule(every_steps=every_steps, every_seconds=every_seconds, keep_last=2)
    st = rzt.CheckpointSchedule(every_steps=every_steps, every_seconds=every_seconds, keep_last=2)
    for step in range(8):
        for last_step in range(-1, step + 1):
            for now, last_time in ((0.0, 0.0), (4.9, 0.0), (5.0, 0.0), (11.0, 5.0)):
                assert st.due(step, last_step, now, last_time) == sj.due(step, last_step, now, last_time)


def test_checkpoint_schedule_validation():
    for kw in ({}, {"every_steps": 0}, {"every_steps": 1, "keep_last": 0}, {"every_seconds": -1.0}):
        with pytest.raises(ValueError):
            rzj.CheckpointSchedule(**kw)
        with pytest.raises(ValueError):
            rzt.CheckpointSchedule(**kw)


# ------------------------------------------------------- supervised fits
def _fit(pkg, kind, directory, faults, block_iters=3):
    """One supervised fit in ``pkg``; returns its state and the
    RECOVERY_STATS deltas and fault records."""
    rz = pkg.resilience
    before = dict(rz.RECOVERY_STATS)
    sup = rz.Supervisor(directory, rz.CheckpointSchedule(every_steps=1, keep_last=2), retry=nosleep(pkg))
    with rz.FaultSchedule(faults) as fs:
        if kind == "lasso":
            est = pkg.regression.Lasso(lam=0.05, max_iter=40, tol=1e-6)
            est.fit(pkg.array(LASSO_X, split=0), pkg.array(LASSO_Y, split=0), supervisor=sup, block_iters=block_iters)
            fitted = (np.asarray(est.theta.numpy()), est.n_iter)
        else:
            init = pkg.array(BLOBS[[0, 1, 2]])
            est = {"kmeans": lambda: pkg.cluster.KMeans(3, init=init, max_iter=11, tol=None),
                   "kmeans_tol": lambda: pkg.cluster.KMeans(3, init=init, max_iter=30, tol=1e-4),
                   "kmedians": lambda: pkg.cluster.KMedians(3, init=init, max_iter=11, tol=1e-4),
                   "kmedoids": lambda: pkg.cluster.KMedoids(3, init=init, max_iter=11)}[kind]()
            est.fit(pkg.array(BLOBS, split=0), supervisor=sup, block_iters=block_iters)
            fitted = (np.asarray(est.cluster_centers_.numpy()), est.n_iter_, np.asarray(est.labels_.numpy()),
                      getattr(est, "inertia_", None))
    counters = {k: rz.RECOVERY_STATS[k] - before[k] for k in before if k != "recovery_seconds_total"}
    return fitted, counters, [(i.site, i.kind) for i in fs.injected], fs.pending()


# the restore: three I/O errors at step 3 exhaust the step's two retries, which escalates to a checkpoint restore
RESTORE = [("supervisor.step", 4, "io_error"), ("supervisor.step", 5, "io_error"), ("supervisor.step", 6, "io_error")]


@pytest.mark.parametrize("faults", [[], RESTORE], ids=["clean", "restore"])
@pytest.mark.parametrize("kind", ["kmeans", "kmeans_tol", "kmedians", "kmedoids", "lasso"])
def test_supervised_fit_matches_heat_tpu(kind, faults, tmp_path):
    block = 3 if kind == "kmeans" else 1  # the converging fits take one iteration a step, to reach step 3
    got = _fit(htt, kind, str(tmp_path / "port"), faults, block)
    want = _fit(htj, kind, str(tmp_path / "ref"), faults, block)
    assert got[1:] == want[1:]  # counters, injected faults, pending events
    assert got[3] == []
    if faults:
        assert got[1]["restores"] == 1 and got[1]["retries"] == 2
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=RTOL, atol=ATOL)
    assert got[0][1] == want[0][1]
    if kind != "lasso":
        np.testing.assert_array_equal(got[0][2], want[0][2])
        if kind.startswith("kmeans"):
            np.testing.assert_allclose(got[0][3], want[0][3], rtol=RTOL)
    # the supervised fit equals the port's own unsupervised fit
    if kind == "lasso":
        plain = htt.regression.Lasso(lam=0.05, max_iter=40, tol=1e-6).fit(htt.array(LASSO_X, split=0),
                                                                          htt.array(LASSO_Y, split=0))
        np.testing.assert_allclose(got[0][0], plain.theta.numpy(), rtol=RTOL, atol=ATOL)
        assert plain.n_iter == got[0][1]


def test_block_iters_must_be_positive():
    x = htt.array(BLOBS, split=0)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(3, init=x[:3]).fit(x, supervisor=rzt.Supervisor(), block_iters=0)


def _bump_state(pkg):
    return {"x": pkg.arange(16, dtype=pkg.float32, split=0), "w": np.arange(3.0), "n": 0}


def _bump(state, data, step):
    return {"x": state["x"] + 1.0, "w": state["w"] * 2.0, "n": state["n"] + 1}, False


@pytest.mark.parametrize("writer,reader", [(htj, htt), (htt, htj)], ids=["heat_tpu_to_port", "port_to_heat_tpu"])
def test_supervisor_directory_resumes_in_the_other_package(writer, reader, tmp_path):
    """A run checkpointed by one package (step-%08d directories, state.json,
    arrays/<name>) resumes in the other at its last step."""
    d = str(tmp_path)
    writer.resilience.supervise(_bump, _bump_state(writer), n_steps=3, directory=d,
                                schedule=writer.resilience.CheckpointSchedule(every_steps=1, keep_last=2))
    res = reader.resilience.supervise(_bump, _bump_state(reader), n_steps=5, directory=d, resume=True,
                                      schedule=reader.resilience.CheckpointSchedule(every_steps=1, keep_last=2))
    assert res.steps == 5 and res.state["n"] == 5
    np.testing.assert_array_equal(np.asarray(res.state["x"].numpy()), np.arange(16, dtype=np.float32) + 5)
    np.testing.assert_array_equal(res.state["w"], np.arange(3.0) * 32)
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step-")) == ["step-00000004",
                                                                                       "step-00000005"]


@pytest.mark.parametrize("fail,exc", [("OSError", "retry"), ("DivergenceError", "restore"), ("RuntimeError", "probe"),
                                      ("NoHealthyDevicesError", "fatal"), ("OutOfMemoryError", "probe"),
                                      ("KeyError", "fatal")])
def test_fault_classes_match_heat_tpu(fail, exc):
    from heat_tpu.resilience.supervisor import _classify as cj
    from heat_tpu_torch.resilience.supervisor import _classify as ct

    make = {"OSError": lambda p: OSError("x"), "DivergenceError": lambda p: p.resilience.DivergenceError("x"),
            "RuntimeError": lambda p: RuntimeError("x"), "KeyError": lambda p: KeyError("x"),
            "NoHealthyDevicesError": lambda p: p.resilience.NoHealthyDevicesError(1)}
    if fail == "OutOfMemoryError":  # torch's OOM is a RuntimeError: its probe passes, so it is re-raised
        import torch

        assert ct(torch.OutOfMemoryError("oom")) == exc
        return
    assert ct(make[fail](htt)) == cj(make[fail](htj)) == exc


def test_runtime_error_with_a_healthy_probe_is_reraised():
    """A RuntimeError whose probe finds the card healthy is not a device
    problem: both packages re-raise it (an out-of-memory error's path)."""
    for pkg in (htj, htt):
        def boom(state, data, step):
            raise RuntimeError("out of memory")

        with pytest.raises(RuntimeError, match="out of memory"):
            pkg.resilience.supervise(boom, {"n": 0}, n_steps=2, retry=nosleep(pkg))


def test_probe_then_shrink_at_world_size_1_has_no_healthy_device():
    """A flapping probe marks the one card (rank 0 / device 0): both
    packages' probe reports it, and shrinking raises
    NoHealthyDevicesError with the same message."""
    out = []
    for pkg in (htj, htt):
        with pkg.resilience.FaultSchedule([("degrade.probe", 1, "device_flap")]) as fs:
            bad = pkg.resilience.probe()
        with pytest.raises(pkg.resilience.NoHealthyDevicesError) as err:
            pkg.resilience.shrink_to_healthy()
        out.append((bad, sorted(pkg.resilience.unhealthy_devices()), str(err.value),
                    [(i.site, i.kind, i.detail) for i in fs.injected]))
        pkg.resilience.clear_unhealthy()
    assert out[1] == out[0] and out[0][0] == [0]


def test_device_loss_cannot_fire_on_one_card():
    """device_loss needs two healthy devices: at world size 1 it stays
    pending in both packages, and the supervised run finishes clean."""
    for pkg in (htj, htt):
        with pkg.resilience.FaultSchedule([("supervisor.step", 1, "device_loss")]) as fs:
            res = pkg.resilience.supervise(_bump, _bump_state(pkg), n_steps=2)
        assert res.steps == 2 and fs.pending() == [("supervisor.step", 1, "device_loss")]


def test_supervised_data_parallel_fit_restores_and_matches_the_plain_fit(tmp_path):
    """DataParallel.fit(supervisor=): 6 steps in blocks of 2, checkpointed
    every block; with three I/O errors at block 2 the supervisor restores
    the last checkpoint and the version token reloads it. Both runs end
    where the plain fit ends (rtol 1e-6: the same float32 steps)."""
    import torch

    rng = np.random.default_rng(7)
    xb = htt.array(rng.normal(size=(32, 4)).astype(np.float32), split=0)
    yb = htt.array(rng.normal(size=(32, 1)).astype(np.float32), split=0)

    def model():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1))
        return htt.nn.DataParallel(m, optimizer=torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9))

    def mse(p, y):
        return torch.mean((p - y) ** 2)

    plain = model().fit(mse, xb, yb, n_steps=6)
    runs = []
    for faults in ([], [("supervisor.step", 3, "io_error"), ("supervisor.step", 4, "io_error"),
                        ("supervisor.step", 5, "io_error")]):
        before = dict(rzt.RECOVERY_STATS)
        sup = rzt.Supervisor(str(tmp_path / str(len(faults))), rzt.CheckpointSchedule(every_steps=1),
                             retry=nosleep(htt))
        with rzt.FaultSchedule(faults):
            dp = model().fit(mse, xb, yb, n_steps=6, supervisor=sup, steps_per_block=2)
        runs.append((dp, rzt.RECOVERY_STATS["restores"] - before["restores"]))
    assert [r for _, r in runs] == [0, 1]
    for dp, _ in runs:
        for (n, p), (_, q) in zip(dp.module.named_parameters(), plain.module.named_parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-6, atol=1e-7, err_msg=n)
