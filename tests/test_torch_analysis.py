"""heat_tpu_torch.analysis on the CPU: the sanitizer's counts and budgets,
``block_host_sync``, the lockstep sanitizer with chaos's
``lockstep_divergence``, the static analyzers' rules (one firing and one
clean fixture each, in torch idioms), and the port's tree held clean by
both analyzers.

Where heat_tpu counts the same thing (host syncs per call, dropped lockstep
events), both packages run the same calls under ``comm_context(SELF)``.
"""
import importlib.util
import os
import sys
import textwrap

import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.analysis import COMPILE_STATS, LOCKSTEP_STATS, Region, SanitizerError, lockstep, sanitizer
from heat_tpu_torch.analysis.sanitizer import waive_host_sync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _load(name, filename):
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(REPO, "heat_tpu_torch", "analysis", filename)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ sanitizer
HOST_CALLS = {
    "numpy": lambda ht, x: x.numpy(),
    "item": lambda ht, x: ht.sum(x).item(),
    "bool": lambda ht, x: bool(ht.sum(x) > 0),
    "float": lambda ht, x: float(ht.max(x)),
    "int": lambda ht, x: int(ht.argmax(x)),
    "tolist": lambda ht, x: x.tolist(),
}


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_syncs_per_call_equal_heat_tpu(name):
    xn = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    got = []
    for ht in (htj, htt):
        x = ht.array(xn, split=0)
        r = ht.analysis.Region(name)
        HOST_CALLS[name](ht, x)
        got.append(r.host_syncs)
    assert got[1] == got[0] >= 1


def test_region_counts_collectives_cache_inserts_and_plans():
    x = htt.array(np.arange(12.0).reshape(4, 3), split=0)
    r = Region("plan")
    with htt.lazy():
        y = x * 2.0 + 0.3125
    y.numpy()
    assert r.traces == 1 and r.cache_inserts >= 1 and r.host_syncs == 1 and r.compiles == 0
    with pytest.raises(SanitizerError, match="expected no host sync"):
        r.assert_no_host_sync()
    with pytest.raises(SanitizerError, match="exactly 1 backend compile"):
        r.assert_compiles(1)
    r.assert_max_compiles(0)
    before = COMPILE_STATS["collectives"]
    htt.core.communication.ragged_process_allgather(np.arange(3), 0)
    assert COMPILE_STATS["collectives"] - before == 1  # its fault point; at world size 1 nothing is sent


def test_block_host_sync_raises_at_the_fetch_and_arms_the_gauge():
    x = htt.array(np.arange(6.0), split=0)
    assert COMPILE_STATS["transfer_guard_armed"] == 0
    with sanitizer("blocked", block_host_sync=True) as region:
        assert region.transfer_guard_armed and COMPILE_STATS["transfer_guard_armed"] == 1
        y = x + 1.0  # stays on the device
        with pytest.raises(SanitizerError, match="host sync 'host.gather'"):
            y.numpy()
        with pytest.raises(SanitizerError, match="host.scalar"):
            float(y[0])
        with waive_host_sync():
            assert y.numpy().tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert COMPILE_STATS["transfer_guard_armed"] == 0
    assert x.numpy().shape == (6,)  # unblocked again


# ------------------------------------------------------------- lockstep
def _drop_sequence(ht):
    from importlib import import_module

    rz = import_module(f"{ht.__name__}.resilience")
    comm_mod = import_module(f"{ht.__name__}.core.communication")
    stats = ht.analysis.LOCKSTEP_STATS
    ht.analysis.reset_lockstep_stats()
    with ht.analysis.lockstep(check_at_exit=False) as ls:
        with rz.FaultSchedule([("collective.allgather", 2, "lockstep_divergence")]) as fs:
            for _ in range(3):
                comm_mod.ragged_process_allgather(np.arange(4), 0)
        ls.check("world one")
    return dict(stats), len(fs.injected), fs.pending()


def test_lockstep_divergence_drops_an_event_as_heat_tpu():
    ref, got = _drop_sequence(htj), _drop_sequence(htt)
    assert got == ref
    assert got[0]["dropped"] == 1 and got[0]["events"] == 3 and got[1] == 1


def test_lockstep_check_every_and_excluded_exchange():
    from heat_tpu_torch.core import _hooks

    with lockstep(check_every=2, check_at_exit=True) as ls:
        _hooks.observe("collective.allreduce", op="allreduce")
        _hooks.observe("collective.exchange", op="halo")  # point to point: not recorded
        _hooks.observe("collective.allgather", op="allgather")
    assert ls.events == 2 and [e[1] for e in ls.entries()] == ["collective.allreduce", "collective.allgather"]
    assert LOCKSTEP_STATS["checks"] >= 2


def test_lockstep_compare_names_the_first_divergent_site():
    from heat_tpu_torch.resilience import LockstepError

    ls = lockstep()
    ls._ring.extend([(0, "collective.allreduce", 1), (1, "collective.allgather", 2)])
    ls._seq = 2
    mine = ls._rows()
    other = mine.copy()
    other[2, 2] = 99  # the peer's second event is another operand
    with pytest.raises(LockstepError, match="seq 1: this process recorded 'collective.allgather'") as e:
        ls._compare([mine, other], "unit")
    assert e.value.seq == 1 and e.value.counts == (2, 2)


# ------------------------------------------------------------- linters
LINT = {
    "G001": ("""
        from heat_tpu_torch.core._cache import ExecutableCache
        PLAN_CACHE = ExecutableCache(8)
        def run(x):
            return PLAN_CACHE.get((lambda t: t + 1, x.shape))
        """, """
        from heat_tpu_torch.core._cache import ExecutableCache
        PLAN_CACHE = ExecutableCache(8)
        def _plus_one(t):
            return t + 1
        def run(x):
            return PLAN_CACHE.get((_plus_one, x.shape))
        """),
    "G002": ("""
        KERNEL_CACHE = {}
        """, """
        from heat_tpu_torch.core._cache import ExecutableCache
        KERNEL_CACHE = ExecutableCache(16)
        """),
    "G003": ("""
        def step(comm, t):
            if comm.rank == 0:
                t = comm.allreduce(t)
            return t
        """, """
        def step(comm, t):
            t = comm.allreduce(t)
            if comm.rank == 0:
                print(t.shape)
            return t
        """),
    "G005": ("""
        def gather_all(comm, tensors):
            for name in {"a", "b"}:
                comm.allgather(tensors[name], 0)
        """, """
        def gather_all(comm, tensors):
            for name in sorted({"a", "b"}):
                comm.allgather(tensors[name], 0)
        """),
    "G006": ("""
        def load(path):
            try:
                return open(path).read()
            except Exception:
                pass
        """, """
        def load(path):
            try:
                return open(path).read()
            except Exception as e:
                raise RuntimeError(path) from e
        """),
}
HOT = {
    "G004": ("""
        import torch
        def scale(t):
            s = float(t.sum())
            torch.cuda.synchronize()
            return t / s, t.max().item()
        """, """
        def scale(t):
            return t / t.sum()
        """),
}
DURABLE = {
    "G007": ("""
        def save(path, data):
            with open(path, "wb") as fh:
                fh.write(data)
        """, """
        from heat_tpu_torch.core._atomic import atomic_write_bytes
        def save(path, data):
            atomic_write_bytes(path, data)
        """),
}


@pytest.mark.parametrize("rule", sorted(LINT) + sorted(HOT) + sorted(DURABLE))
def test_graftlint_rule_fires_and_stays_quiet(rule, tmp_path):
    gl = _load("_torch_graftlint", "graftlint.py")
    bad, good = {**LINT, **HOT, **DURABLE}[rule]
    pragma = "# graftlint: hot-path\n" if rule in HOT else "# graftlint: durable-path\n" if rule in DURABLE else ""
    fired = [f.rule for f in gl.lint_source(pragma + textwrap.dedent(bad), "fixture.py")]
    quiet = [f.rule for f in gl.lint_source(pragma + textwrap.dedent(good), "fixture.py")]
    assert rule in fired and rule not in quiet, (fired, quiet)



def test_graftlint_g004_tells_numpy_arrays_from_tensors():
    """G004 stays quiet on numpy arrays (a parameter annotated np.ndarray,
    names assigned from np.* or from a method or arithmetic of one) and
    fires on tensors, a name rebound to a tensor included."""
    gl = _load("_torch_graftlint", "graftlint.py")
    src = textwrap.dedent("""\
        # graftlint: hot-path
        import numpy as np
        import torch
        def f(t, q: np.ndarray):
            ranks = np.unique(q)
            pos = q.astype(np.float64) / 100.0
            host = ranks.tolist(), pos.tolist(), q.tolist(), np.asarray([1.0]).item()
            ranks = torch.as_tensor(ranks)
            pos, other = t, t
            return host, t.tolist(), ranks.tolist(), pos.tolist()
        """)
    fired = [(f.rule, f.line) for f in gl.lint_source(src, "fixture.py")]
    assert fired == [("G004", 10)] * 3, fired  # t, ranks and pos: the three tensors of the last line


FLOW = {
    "F001": ("""
        def f(comm, t):
            r = comm.rank
            if r == 0:
                t = comm.allreduce(t)
            return t
        """, """
        def f(comm, t):
            r = comm.rank
            if r == 0:
                t = comm.allreduce(t)
            else:
                t = comm.allreduce(t)
            return t
        """),
    "F002": ("""
        PLAN_CACHE = {}
        def f(x):
            return PLAN_CACHE[x.lshape]
        """, """
        PLAN_CACHE = {}
        def f(x):
            return PLAN_CACHE[x.gshape]
        """),
    "F003": ("""
        def f(comm, x):
            for _ in range(x.lshape[0]):
                comm.allreduce(x.larray)
        """, """
        def f(comm, x):
            for _ in range(x.gshape[0]):
                comm.allreduce(x.larray)
        """),
    "F004": ("""
        def f(comm, t):
            if comm.rank == 1:
                return t
            return comm.allgather(t, 0)
        """, """
        def f(comm, t):
            g = comm.allgather(t, 0)
            if comm.rank == 1:
                return t
            return g
        """),
    "F005": ("""
        import torch.distributed as dist
        def f(obj):
            out = [None] * dist.get_world_size()
            dist.all_gather_object(out, obj)
            return out
        """, """
        import torch.distributed as dist
        def f(t):
            out = [t.clone() for _ in range(dist.get_world_size())]
            dist.all_gather(out, t)
            return out
        """),
    "F006": ("""
        def f(comm, xs):
            for x in xs:
                comm.allreduce(x)
                print(x.cpu())
        """, """
        def f(comm, xs):
            for x in xs:
                comm.allreduce(x)
            print([x.shape for x in xs])
        """),
    "F007": ("""
        import subprocess
        import heat_tpu_torch as ht
        def main():
            ht.init_distributed(backend="gloo")
            subprocess.run(["true"])
        """, """
        import subprocess
        import heat_tpu_torch as ht
        def main():
            subprocess.run(["true"])
            ht.init_distributed(backend="gloo")
        """),
    "F008": ("""
        # graftflow: threaded
        def f(comm, t):
            return comm.allreduce(t)
        """, """
        # graftflow: threaded
        from heat_tpu_torch.core.communication import collective_lockstep
        def f(comm, t):
            return collective_lockstep(comm.allreduce(t))
        """),
    "F009": ("""
        import time
        def f(comm, t, t0):
            if time.monotonic() - t0 > 5.0:
                t = comm.allreduce(t)
            return t
        """, """
        import time
        from heat_tpu_torch.core.communication import replicated_decision
        def f(comm, t, t0):
            if replicated_decision(time.monotonic() - t0 > 5.0, comm):
                t = comm.allreduce(t)
            return t
        """),
}


@pytest.mark.parametrize("rule", sorted(FLOW))
def test_graftflow_rule_fires_and_stays_quiet(rule):
    gf = _load("_torch_graftflow", "graftflow.py")
    bad, good = FLOW[rule]
    fired = [f.rule for f in gf.analyze_source(textwrap.dedent(bad), "fixture.py")]
    quiet = [f.rule for f in gf.analyze_source(textwrap.dedent(good), "fixture.py")]
    assert rule in fired and rule not in quiet, (fired, quiet)


def test_waiver_syntax_is_heat_tpus():
    gl = _load("_torch_graftlint", "graftlint.py")
    src = "KERNEL_CACHE = {}  # graftlint: G002 - keyed by device index: bounded by the card count\n"
    assert gl.lint_source(src, "fixture.py") == []


def test_port_tree_is_lint_clean():
    """Every graftlint finding over heat_tpu_torch/ is fixed or waived in
    code with its reason."""
    gl = _load("_torch_graftlint", "graftlint.py")
    findings, files = gl.lint_paths([os.path.join(REPO, "heat_tpu_torch")])
    assert files > 100 and not findings, [f.as_dict() for f in findings][:10]


def test_port_tree_is_flow_clean():
    """Every graftflow finding (F001-F009, DRIFT) over heat_tpu_torch/ is
    fixed or waived in code with its reason."""
    gf = _load("_torch_graftflow", "graftflow.py")
    findings, files = gf.analyze_paths([os.path.join(REPO, "heat_tpu_torch")])
    assert files > 100 and not findings, [f.as_dict() for f in findings][:10]


def test_graftcheck_gate_exit_code():
    gc = _load("_torch_graftcheck", "graftcheck.py")
    report = gc.run_check([os.path.join(REPO, "heat_tpu_torch", "core", "lazy")])
    assert report["exit_code"] == 0 and report["files_checked"] == 4
    bad = gc.run_check([os.path.join(REPO, "tests", "lint_fixtures")])
    assert bad["exit_code"] & 1 and bad["counts"]
