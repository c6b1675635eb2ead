"""Fault-tolerant process-pool coordinator for whole-suite multi-process
execution (counterpart of ``heat_tpu/testing/runner.py``).

A :class:`SuiteRunner` owns one or more :class:`WorkerGroup`\\ s — each a
set of ``world_size`` long-lived ``heat_tpu_torch.testing.worker``
processes joined into one ``torch.distributed`` group from torchrun's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; gloo on the CPU, NCCL where ``device="cuda"``) — and drives
every collected test through them:

- the group start, imports and collection are paid once per group;
- each ``run`` command fans out to all ranks (collective-bearing tests
  run in lockstep), and per-rank ``result`` records stream back over
  line-JSON pipes (:mod:`.protocol`);
- every test gets a wall-clock deadline: in the worker the collective
  watchdog (``resilience.deadlines``) turns a wedged labelled host path
  into a named ``CollectiveTimeout``; here a hard timeout kills and
  recycles a group that stops answering and records the in-flight test
  as a ``restart-failure`` — the suite never hangs;
- a crashed or wedged group restarts with exponential backoff, at most
  ``max_restarts`` times, each restart a visible ``restart`` event;
- tests listed in the quarantine file are reported as ``quarantined``.

Pure stdlib: the coordinator never imports torch or jax, so supervision
stays alive when a worker's runtime wedges.
"""
from __future__ import annotations

import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import protocol
from .quarantine import load_quarantine, match_quarantine

__all__ = [
    "RunnerConfig",
    "RunnerError",
    "GroupCrash",
    "SuiteResult",
    "SuiteRunner",
    "WorkerGroup",
    "sample_ids",
]

# base pytest flags every worker runs with: deterministic collection
# order and no cross-run caches — all ranks of a group MUST collect the
# identical id list or lockstep execution is impossible
BASE_PYTEST_ARGS = [
    "-q", "--no-header", "-p", "no:cacheprovider", "-p", "no:randomly",
    "-p", "no:xdist", "--continue-on-collection-errors",
]


class RunnerError(RuntimeError):
    """Coordinator-level failure (divergent collection, startup failure
    past the restart budget) — named, never a hang."""


class GroupCrash(RuntimeError):
    """One worker group died or stopped answering; carries the in-flight
    test id and a diagnostic tail of the worker logs."""

    def __init__(self, message: str, in_flight: str = ""):
        super().__init__(message)
        self.in_flight = in_flight


@dataclass
class RunnerConfig:
    world_size: int = 2
    n_groups: int = 1
    device: str = "cpu"             # "cpu": gloo; "cuda": NCCL, one card per rank
    deadline: float = 120.0         # per-test wall-clock seconds
    grace: float = 30.0             # extra wait past the worker's own deadline
    startup_timeout: float = 420.0  # group boot + full collection
    max_restarts: int = 5           # per group, then remaining tests fail
    backoff_base: float = 0.5       # exponential restart backoff (seconds)
    backoff_max: float = 30.0
    pytest_args: List[str] = field(default_factory=lambda: ["-m", "not slow", "tests"])
    repo_root: str = "."
    quarantine_path: Optional[str] = None   # default: tests/ws_quarantine.txt
    sample: Optional[int] = None    # deterministic subset size (None = all)
    sample_seed: int = 0
    log_dir: Optional[str] = None   # worker logs land here (temp otherwise)
    env: Dict[str, str] = field(default_factory=dict)
    sleep: Callable[[float], None] = time.sleep  # injectable for tests


@dataclass
class SuiteResult:
    world_size: int
    results: Dict[str, dict]        # test id -> merged suite-level record
    events: List[dict]              # restart / fatal records, stream order
    wall_seconds: float
    restarts: int
    collected: int

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for rec in self.results.values():
            c[rec["outcome"]] = c.get(rec["outcome"], 0) + 1
        return c

    @property
    def ok(self) -> bool:
        bad = {"failed", "error", "restart-failure", "uneven"}
        return not any(r["outcome"] in bad for r in self.results.values())


def sample_ids(ids: List[str], n: int, seed: int = 0) -> List[str]:
    """A deterministic, seed-keyed, order-independent subset: ids ranked
    by ``sha1(seed:id)`` — the same N tests on every host and every run,
    no RNG state involved."""
    import hashlib

    if n >= len(ids):
        return list(ids)
    ranked = sorted(ids, key=lambda t: hashlib.sha1(
        f"{seed}:{t}".encode()).hexdigest())
    return sorted(ranked[:n], key=ids.index)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: str, limit: int = 1800) -> str:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            text = fh.read()
        return text[-limit:]
    except OSError:
        return "<no worker log>"


class WorkerGroup:
    """``world_size`` lockstepped worker processes + their pipes/readers."""

    def __init__(self, config: RunnerConfig, group_id: int, logs_root: str):
        self.config = config
        self.group_id = group_id
        self.procs: List[subprocess.Popen] = []
        self.ctl_files = []             # coordinator -> worker command pipes
        self.records: "queue.Queue" = queue.Queue()
        self.collected_ids: List[str] = []
        self.logs: List[str] = []
        self.shared_root = tempfile.mkdtemp(
            prefix=f"heat-tpu-torch-runner-ws{config.world_size}-g{group_id}-")
        self.logs_root = logs_root
        self._readers: List[threading.Thread] = []
        self._alive = False

    # ------------------------------------------------------------------ boot
    def start(self) -> None:
        cfg = self.config
        port = _free_port()
        env = dict(os.environ)
        repo = os.path.abspath(cfg.repo_root)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["HEAT_TPU_TORCH_WS_SHARED_ROOT"] = self.shared_root
        # torchrun's environment: the workers join one group through env://
        env["MASTER_ADDR"] = "localhost"
        env["MASTER_PORT"] = str(port)
        env["WORLD_SIZE"] = str(cfg.world_size)
        if cfg.device == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")  # gloo ranks with all threads each crawl
        env.update(cfg.env)
        for rank in range(cfg.world_size):
            env = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
            ctl_r, ctl_w = os.pipe()
            res_r, res_w = os.pipe()
            os.set_inheritable(ctl_r, True)
            os.set_inheritable(res_w, True)
            log_path = os.path.join(
                self.logs_root, f"g{self.group_id}-rank{rank}.log")
            self.logs.append(log_path)
            log_fh = open(log_path, "ab")
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "heat_tpu_torch.testing.worker",
                    "--rank", str(rank), "--nproc", str(cfg.world_size),
                    "--device", cfg.device, "--ctl-fd", str(ctl_r),
                    "--res-fd", str(res_w), "--deadline", str(cfg.deadline),
                    "--", *BASE_PYTEST_ARGS, *cfg.pytest_args,
                ],
                cwd=repo, env=env, pass_fds=(ctl_r, res_w),
                stdout=log_fh, stderr=subprocess.STDOUT,
            )
            log_fh.close()
            os.close(ctl_r)
            os.close(res_w)
            self.procs.append(proc)
            self.ctl_files.append(os.fdopen(ctl_w, "w", encoding="utf-8"))
            reader = threading.Thread(
                target=self._read_results, args=(rank, res_r),
                name=f"htr-g{self.group_id}-r{rank}", daemon=True,
            )
            reader.start()
            self._readers.append(reader)
        self._alive = True
        self._await_collection()

    def _read_results(self, rank: int, res_r: int) -> None:
        with os.fdopen(res_r, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                rec = protocol.decode(line)
                if rec is not None:
                    self.records.put((rank, rec))
        self.records.put((rank, {"kind": "eof"}))

    def _await_collection(self) -> None:
        """Block until every rank reports its collected id list; the lists
        must be IDENTICAL — divergent collection is a real SPMD bug (a
        per-host conditional in a test module) and is named as such."""
        per_rank: Dict[int, List[str]] = {}
        deadline = time.monotonic() + self.config.startup_timeout
        ready = set()
        while len(ready) < self.config.world_size:
            rank, rec = self._next_record(deadline, context="startup/collection")
            if rec["kind"] == "collected":
                per_rank[rank] = rec["ids"]
            elif rec["kind"] == "ready":
                ready.add(rank)
            elif rec["kind"] in ("eof", "fatal"):
                raise GroupCrash(
                    f"group {self.group_id} rank {rank} died during startup: "
                    f"{rec.get('error', 'worker exited')}\n"
                    f"--- log tail ---\n{_tail(self.logs[rank])}")
        base = per_rank.get(0, [])
        for rank, ids in per_rank.items():
            if ids != base:
                diff = sorted(set(ids) ^ set(base))[:10]
                raise RunnerError(
                    f"ranks 0 and {rank} collected DIFFERENT test sets "
                    f"({len(base)} vs {len(ids)}; first diffs: {diff}) — "
                    "a test module branches collection on per-host state")
        self.collected_ids = base

    def _next_record(self, deadline: float, context: str):
        timeout = deadline - time.monotonic()
        if timeout <= 0:
            raise GroupCrash(
                f"group {self.group_id} produced no record within its "
                f"{context} deadline\n--- rank log tails ---\n"
                + "\n".join(_tail(p, 600) for p in self.logs))
        try:
            return self.records.get(timeout=timeout)
        except queue.Empty:
            raise GroupCrash(
                f"group {self.group_id} produced no record within its "
                f"{context} deadline\n--- rank log tails ---\n"
                + "\n".join(_tail(p, 600) for p in self.logs)) from None

    # ------------------------------------------------------------------ run
    def run_test(self, test_id: str, deadline: float) -> dict:
        """Execute one test on every rank; return the merged suite-level
        record. Raises :class:`GroupCrash` if any rank dies or the group
        blows the coordinator-side hard deadline."""
        cmd = protocol.encode({"cmd": "run", "id": test_id,
                               "deadline": deadline})
        for fh in self.ctl_files:
            try:
                fh.write(cmd)
                fh.flush()
            except (OSError, ValueError) as e:
                raise GroupCrash(
                    f"group {self.group_id} control pipe is gone ({e!r})",
                    in_flight=test_id) from e
        # worker-side watchdog fires at `deadline`; give it room to report
        # the named CollectiveTimeout before the hard kill
        hard = time.monotonic() + deadline * 1.5 + self.config.grace
        per_rank: Dict[int, dict] = {}
        while len(per_rank) < self.config.world_size:
            try:
                rank, rec = self._next_record(hard, context=f"test {test_id}")
            except GroupCrash as e:
                e.in_flight = test_id
                raise
            if rec["kind"] == "result" and rec.get("id") == test_id:
                per_rank[rank] = rec
            elif rec["kind"] in ("eof", "fatal"):
                raise GroupCrash(
                    f"group {self.group_id} rank {rank} died while running "
                    f"{test_id}: {rec.get('error', 'worker exited')}\n"
                    f"--- log tail ---\n{_tail(self.logs[rank])}",
                    in_flight=test_id)
        return protocol.merge_rank_results(
            [per_rank[r] for r in sorted(per_rank)])

    # ------------------------------------------------------------- teardown
    def shutdown(self, grace: float = 30.0) -> None:
        if not self._alive:
            return
        cmd = protocol.encode({"cmd": "shutdown"})
        for fh in self.ctl_files:
            try:
                fh.write(cmd)
                fh.flush()
                fh.close()
            except (OSError, ValueError):
                pass  # already dead: kill() below reaps it
        deadline = time.monotonic() + grace
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
        self.kill()

    def kill(self) -> None:
        self._alive = False
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass  # kernel will reap it; do not wedge the coordinator
        for fh in self.ctl_files:
            try:
                fh.close()
            except OSError:
                pass
        shutil.rmtree(self.shared_root, ignore_errors=True)


class SuiteRunner:
    """Drive the whole suite through restartable worker groups."""

    def __init__(self, config: RunnerConfig,
                 on_event: Optional[Callable[[dict], None]] = None):
        self.config = config
        self.on_event = on_event or (lambda rec: None)
        self._lock = threading.Lock()

    def _emit(self, rec: dict) -> None:
        with self._lock:
            self.on_event(rec)

    # ------------------------------------------------------------- schedule
    @staticmethod
    def _partition(ids: List[str], n_groups: int) -> List[List[str]]:
        """Contiguous per-FILE blocks, greedily balanced across groups:
        module import/fixture state amortizes within a group, and no test
        file ever spans two groups."""
        files: List[List[str]] = []
        current_file, block = None, []
        for tid in ids:
            f = tid.split("::", 1)[0]
            if f != current_file:
                if block:
                    files.append(block)
                current_file, block = f, []
            block.append(tid)
        if block:
            files.append(block)
        buckets: List[List[str]] = [[] for _ in range(n_groups)]
        sizes = [0] * n_groups
        for fblock in sorted(files, key=len, reverse=True):
            g = sizes.index(min(sizes))
            buckets[g].extend(fblock)
            sizes[g] += len(fblock)
        return buckets

    # ------------------------------------------------------------------ run
    def run(self) -> SuiteResult:
        cfg = self.config
        t0 = time.perf_counter()
        logs_root = cfg.log_dir or tempfile.mkdtemp(prefix="heat-tpu-torch-runner-logs-")
        os.makedirs(logs_root, exist_ok=True)
        results: Dict[str, dict] = {}
        events: List[dict] = []
        restarts = [0]

        # boot group 0 first to learn the collected id list
        group0 = self._start_with_retry(0, logs_root, events, restarts)
        all_ids = list(group0.collected_ids)

        # an explicitly-passed quarantine file is always honored; the
        # default tests/ws_quarantine.txt documents ws>1-only breakage,
        # so single-process runs still execute those tests
        qpath = cfg.quarantine_path or os.path.join(
            os.path.abspath(cfg.repo_root), "tests", "ws_quarantine.txt")
        apply_q = cfg.quarantine_path is not None or cfg.world_size > 1
        quarantined, runnable = match_quarantine(
            all_ids, load_quarantine(qpath) if apply_q else {})
        for tid, reason in quarantined.items():
            rec = protocol.result_record(
                tid, "quarantined", -1, 0.0, error=reason)
            results[tid] = rec
            self._emit(rec)
        if cfg.sample is not None:
            runnable = sample_ids(runnable, cfg.sample, cfg.sample_seed)

        buckets = self._partition(runnable, max(1, cfg.n_groups))
        groups: List[Optional[WorkerGroup]] = [group0] + [None] * (len(buckets) - 1)

        def drive(gidx: int) -> None:
            group = groups[gidx]
            my_restarts = 0
            ids = buckets[gidx]
            i = 0
            while i < len(ids):
                if group is None:
                    try:
                        group = self._start_with_retry(
                            gidx, logs_root, events, restarts)
                    except RunnerError as e:
                        for tid in ids[i:]:
                            rec = protocol.result_record(
                                tid, "restart-failure", -1, 0.0,
                                error=f"group {gidx} unrecoverable: {e}",
                                exc_type="WorkerRestartBudget")
                            with self._lock:
                                results[tid] = rec
                            self._emit(rec)
                        return
                tid = ids[i]
                try:
                    rec = group.run_test(tid, cfg.deadline)
                    with self._lock:
                        results[tid] = rec
                    self._emit(rec)
                    i += 1
                except GroupCrash as e:
                    group.kill()
                    group = None
                    my_restarts += 1
                    restarts[0] += 1
                    reason = str(e).splitlines()[0]
                    event = {"kind": "restart", "group": gidx,
                             "restart": my_restarts, "in_flight": tid,
                             "reason": reason}
                    with self._lock:
                        events.append(event)
                    self._emit(event)
                    rec = protocol.result_record(
                        tid, "restart-failure", -1, cfg.deadline,
                        error=f"worker group {gidx} crashed/hung during this "
                              f"test (restart #{my_restarts}): {reason}",
                        exc_type="WorkerRestart")
                    with self._lock:
                        results[tid] = rec
                    self._emit(rec)
                    i += 1  # recorded, NOT retried: deterministic accounting
                    if my_restarts > cfg.max_restarts:
                        for rem in ids[i:]:
                            rec = protocol.result_record(
                                rem, "restart-failure", -1, 0.0,
                                error=f"group {gidx} restart budget "
                                      f"({cfg.max_restarts}) exhausted",
                                exc_type="WorkerRestartBudget")
                            with self._lock:
                                results[rem] = rec
                            self._emit(rec)
                        return
                    cfg.sleep(min(cfg.backoff_max,
                                  cfg.backoff_base * (2 ** (my_restarts - 1))))
            if group is not None:
                groups[gidx] = group

        threads = [
            threading.Thread(target=drive, args=(g,), name=f"htr-drive-{g}")
            for g in range(len(buckets))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for group in groups:
            if group is not None:
                group.shutdown()
        return SuiteResult(
            world_size=cfg.world_size,
            results=results,
            events=events,
            wall_seconds=round(time.perf_counter() - t0, 2),
            restarts=restarts[0],
            collected=len(all_ids),
        )

    def _start_with_retry(self, gidx: int, logs_root: str,
                          events: List[dict], restarts: List[int]) -> WorkerGroup:
        """Boot a group; a startup crash consumes restart budget with the
        same exponential backoff as a mid-run crash."""
        cfg = self.config
        attempt = 0
        while True:
            group = WorkerGroup(cfg, gidx, logs_root)
            try:
                group.start()
                return group
            except GroupCrash as e:
                group.kill()
                attempt += 1
                restarts[0] += 1
                event = {"kind": "restart", "group": gidx,
                         "restart": attempt, "in_flight": "",
                         "reason": f"startup failure: {str(e).splitlines()[0]}"}
                with self._lock:
                    events.append(event)
                self._emit(event)
                if attempt > cfg.max_restarts:
                    raise RunnerError(
                        f"group {gidx} failed to start "
                        f"{attempt} times; last: {e}") from e
                cfg.sleep(min(cfg.backoff_max,
                              cfg.backoff_base * (2 ** (attempt - 1))))
