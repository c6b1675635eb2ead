"""Line-JSON result protocol between suite workers and the coordinator.

One record per line, each line prefixed with a sentinel so protocol
traffic survives interleaving with arbitrary test stdout (a worker's
result pipe is dedicated, but the prefix also lets the coordinator's
log-scraping fallback recover records from a crashed worker's combined
log). The vocabulary is deliberately tiny and versioned:

``hello``      worker process is up (rank, pid, world size)
``collected``  the worker's pytest collection finished (sorted test ids)
``ready``      the worker entered its run loop and will accept commands
``start``      a test began executing on this rank
``result``     one test finished on this rank (outcome, duration, error)
``restart``    coordinator-side event: a worker group was killed and
               respawned (the in-flight test id rides along)
``fatal``      the worker is about to die and says why

Commands flow the other way (coordinator -> worker control pipe) with the
same framing: ``{"cmd": "run", "id": ..., "deadline": ...}`` and
``{"cmd": "shutdown"}``.

This module is pure stdlib (no torch, no jax, no package imports) so the
coordinator — ``tools/torch_mpirun.py`` — loads it without starting an
accelerator runtime. It is ``heat_tpu/testing/protocol.py``'s protocol, so
records of either runner read the same.
"""
from __future__ import annotations

import json
from typing import Optional

PROTOCOL_VERSION = 1

# sentinel prefix: never produced by pytest/test output lines
SENTINEL = "@heat-tpu-runner@ "

RECORD_KINDS = {
    "hello", "collected", "ready", "start", "result", "restart", "fatal",
}

OUTCOMES = {
    "passed", "failed", "skipped", "error", "quarantined",
    "restart-failure", "uneven",
}


def encode(record: dict) -> str:
    """One protocol line (sentinel + compact JSON, no interior newlines).

    Raises ``ValueError`` for records without a known ``kind`` — a typo'd
    producer fails loudly at the source instead of silently dropping on
    the consumer's floor.
    """
    kind = record.get("kind")
    if kind not in RECORD_KINDS and record.get("cmd") is None:
        raise ValueError(f"record needs a known 'kind' or a 'cmd': {record!r}")
    body = json.dumps(record, sort_keys=True, separators=(",", ":"))
    if "\n" in body:  # embedded newlines would split the frame
        body = body.replace("\n", "\\n")
    return SENTINEL + body + "\n"


def decode(line: str) -> Optional[dict]:
    """Parse one line back into a record.

    Returns ``None`` for anything that is not a protocol line (test
    chatter, tracebacks, truncated frames from a killed worker) — the
    reader loop skips those instead of dying on them.
    """
    line = line.strip()
    if not line.startswith(SENTINEL.strip()):
        return None
    body = line[len(SENTINEL.strip()):].strip()
    try:
        obj = json.loads(body)
    except ValueError:
        return None  # torn frame from a killed worker mid-write
    if not isinstance(obj, dict):
        return None
    if obj.get("kind") not in RECORD_KINDS and obj.get("cmd") is None:
        return None
    return obj


def result_record(
    test_id: str,
    outcome: str,
    rank: int,
    duration: float,
    error: str = "",
    exc_type: str = "",
) -> dict:
    """Build a ``result`` record; long error text is clipped so one frame
    stays well under a pipe's atomic-write unit."""
    if outcome not in OUTCOMES:
        raise ValueError(f"unknown outcome {outcome!r}")
    return {
        "kind": "result",
        "id": test_id,
        "outcome": outcome,
        "rank": int(rank),
        "duration": round(float(duration), 4),
        "error": error[:1500],
        "exc_type": exc_type[:120],
        "v": PROTOCOL_VERSION,
    }


def merge_rank_results(records: list) -> dict:
    """Collapse one test's per-rank ``result`` records into the suite-level
    verdict.

    Any rank failing fails the test; a rank-dependent outcome (ran on one
    rank, skipped on another) is its own named failure class ``uneven`` —
    under SPMD execution it is exactly as wrong as an assertion error.
    """
    if not records:
        raise ValueError("no rank results to merge")
    outcomes = {r["outcome"] for r in records}
    merged = dict(records[0])
    merged["rank"] = -1  # suite-level verdict, not one rank's
    merged["duration"] = max(float(r["duration"]) for r in records)
    bad = [r for r in records if r["outcome"] in ("failed", "error", "restart-failure")]
    if bad:
        merged["outcome"] = "failed" if any(
            r["outcome"] == "failed" for r in bad
        ) else bad[0]["outcome"]
        merged["error"] = bad[0]["error"]
        merged["exc_type"] = bad[0]["exc_type"]
        merged["ranks_failed"] = sorted(int(r["rank"]) for r in bad)
    elif len(outcomes) > 1:
        merged["outcome"] = "uneven"
        merged["error"] = "rank-dependent outcome: " + ", ".join(
            f"rank {int(r['rank'])}={r['outcome']}" for r in records
        )
        merged["exc_type"] = "UnevenOutcome"
    return merged
