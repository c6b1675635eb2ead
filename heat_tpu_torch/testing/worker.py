"""Suite-pool worker: one long-lived pytest process inside a
``torch.distributed`` group (counterpart of ``heat_tpu/testing/worker.py``).

Launched by the coordinator (:mod:`.runner`) with torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) as::

    python -m heat_tpu_torch.testing.worker --rank R --nproc N --device cpu|cuda \
        --ctl-fd C --res-fd S [--deadline T] -- <pytest args...>

The worker joins the N-process group (gloo on the CPU, NCCL on cards; all
ranks run the same commands in the same order, so collective-bearing
tests run in lockstep), collects the suite once, then loops: read a
command from the control pipe, run that one test through pytest's own
``runtest_protocol``, stream a line-JSON ``result`` record back.

Every test runs inside ``resilience.deadlines(deadline)``, so a wedged
labelled host path surfaces as a named ``CollectiveTimeout`` failure; an
unlabelled hang is the coordinator's (its wall deadline recycles the group).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from . import protocol


def _emit(res_fd: int, record: dict) -> None:
    """One atomic line on the result pipe (frames < PIPE_BUF never tear)."""
    try:
        os.write(res_fd, protocol.encode(record).encode("utf-8"))
    except OSError:
        # coordinator gone: nothing left to report to — die quietly rather
        # than stack-trace into a log nobody reads
        os._exit(3)


class PoolWorkerPlugin:
    """Replaces pytest's run loop with a command-driven one."""

    def __init__(self, rank: int, nproc: int, ctl_fd: int, res_fd: int,
                 deadline: float):
        self.rank = rank
        self.nproc = nproc
        self.ctl = os.fdopen(ctl_fd, "r", encoding="utf-8")
        self.res_fd = res_fd
        self.deadline = deadline
        self.items = {}
        self._reports = []

    # ------------------------------------------------------------ collection
    def pytest_collection_finish(self, session):
        self.items = {item.nodeid: item for item in session.items}
        _emit(self.res_fd, {
            "kind": "collected",
            "rank": self.rank,
            "n": len(self.items),
            "ids": sorted(self.items),
            "v": protocol.PROTOCOL_VERSION,
        })

    # ------------------------------------------------------------- reporting
    def pytest_runtest_logreport(self, report):
        self._reports.append(report)

    def _verdict(self):
        outcome, error, exc_type = "passed", "", ""
        for rep in self._reports:
            if rep.failed:
                outcome = "failed" if rep.when == "call" else "error"
                error = str(rep.longrepr)
                exc_type = _exc_type_of(rep)
                break
            if rep.skipped:
                outcome = "skipped"
                error = str(rep.longrepr)
        return outcome, error, exc_type

    # -------------------------------------------------------------- run loop
    def pytest_runtestloop(self, session):
        import heat_tpu_torch as ht
        from heat_tpu_torch import resilience as rz

        _emit(self.res_fd, {"kind": "ready", "rank": self.rank,
                            "n": len(self.items)})
        for line in self.ctl:
            cmd = protocol.decode(line)
            if cmd is None:
                continue
            if cmd.get("cmd") == "shutdown":
                break
            if cmd.get("cmd") != "run":
                continue
            tid = cmd.get("id", "")
            deadline = float(cmd.get("deadline") or self.deadline)
            item = self.items.get(tid)
            if item is None:
                _emit(self.res_fd, protocol.result_record(
                    tid, "error", self.rank, 0.0,
                    error=f"unknown test id {tid!r} (collection mismatch)",
                    exc_type="UnknownTestId"))
                continue
            _emit(self.res_fd, {"kind": "start", "rank": self.rank, "id": tid})
            self._reports = []
            t0 = time.perf_counter()
            try:
                with rz.deadlines(deadline):
                    # nextitem=None: full teardown after each test — a
                    # leaked module fixture must not poison the next
                    # hundred tests sharing this long-lived process
                    item.config.hook.pytest_runtest_protocol(
                        item=item, nextitem=None)
                outcome, error, exc_type = self._verdict()
            except BaseException as e:  # noqa: BLE001 - reported upstream
                outcome = "error"
                error = "".join(traceback.format_exception_only(type(e), e))
                exc_type = type(e).__name__
            dt = time.perf_counter() - t0
            self._reset_global_state(ht, rz)
            _emit(self.res_fd, protocol.result_record(
                tid, outcome, self.rank, dt, error=error, exc_type=exc_type))
        return True  # suppress pytest's own loop

    @staticmethod
    def _reset_global_state(ht, rz):
        """Undo the cross-test global mutations a misbehaving test can
        leave behind in a persistent process: a swapped default
        communicator or lingering unhealthy-device marks would fail every
        subsequent test in the group for the wrong reason."""
        from heat_tpu_torch.core import communication

        try:
            communication.use_comm(None)
            rz.clear_unhealthy()
        except Exception as e:  # noqa: BLE001 - cleanup is best-effort
            sys.stderr.write(f"worker state reset failed: {e!r}\n")


def _exc_type_of(report) -> str:
    """Best-effort exception class name from a pytest report (named
    failures are the acceptance bar: CollectiveTimeout must say so)."""
    try:
        crash = getattr(report.longrepr, "reprcrash", None)
        if crash is not None:
            # "path:line: ExcType: message" -> ExcType
            msg = crash.message.split(":", 1)[0].strip()
            return msg.split()[0] if msg else ""
    except Exception as e:  # noqa: BLE001 - cosmetic field; the full
        # failure text still travels in the record's 'error'
        return f"<unparsed:{type(e).__name__}>"
    return ""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="heat-tpu-torch-suite-worker")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--nproc", type=int, required=True)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--ctl-fd", type=int, required=True)
    parser.add_argument("--res-fd", type=int, required=True)
    parser.add_argument("--deadline", type=float, default=120.0)
    parser.add_argument("pytest_args", nargs="*")
    args = parser.parse_args(argv)

    # numpy resolves ``np.testing`` lazily and probes CPU features through a
    # subprocess; pytest loads its entry-point plugins at startup. Import both
    # now, while this process is single-threaded, before the group's threads
    # start (F007).
    import numpy.testing  # noqa: F401
    import pytest

    _emit(args.res_fd, {"kind": "hello", "rank": args.rank,
                        "pid": os.getpid(), "nproc": args.nproc,
                        "v": protocol.PROTOCOL_VERSION})
    import heat_tpu_torch as ht

    if args.device == "cpu":
        ht.use_device("cpu")
    if args.nproc > 1:
        # MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE come from the coordinator
        ht.init_distributed(backend="gloo" if args.device == "cpu" else "nccl",
                            world_size=args.nproc, rank=args.rank)

    plugin = PoolWorkerPlugin(
        args.rank, args.nproc, args.ctl_fd, args.res_fd, args.deadline
    )
    try:
        rc = pytest.main(list(args.pytest_args), plugins=[plugin])
    except BaseException as e:  # noqa: BLE001 - reported upstream
        _emit(args.res_fd, {"kind": "fatal", "rank": args.rank,
                            "error": repr(e)[:1500]})
        raise
    # per-test failures were already streamed; only a pytest-level usage/
    # internal error (rc >= 2) is a worker failure
    return 0 if rc in (0, 1) else int(rc)


if __name__ == "__main__":
    sys.exit(main())
