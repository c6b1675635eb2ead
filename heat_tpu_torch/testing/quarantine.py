"""The deterministic quarantine list: known-bad tests under real
multi-process execution, kept VISIBLE instead of silently skipped.

Format of ``tests/ws_quarantine.txt`` — one entry per line::

    tests/test_foo.py::test_bar  # reason the test cannot run at ws>1

The reason is mandatory: an entry without one is a parse error, so a
hurried ``echo id >> ws_quarantine.txt`` cannot silently grow the list
undocumented. Whole-file comment lines start with ``#``; blank lines are
ignored. A prefix entry (``tests/test_foo.py`` or
``tests/test_foo.py::TestClass``) quarantines every test it prefixes —
the file documents *why*, and the runner reports each quarantined id in
its streamed results with that reason.

Pure stdlib (no torch, no jax import) — the coordinator parses this file before
any worker exists.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

DEFAULT_QUARANTINE = os.path.join("tests", "ws_quarantine.txt")


def parse_quarantine_text(text: str, origin: str = "<string>") -> Dict[str, str]:
    """``{entry: reason}`` in file order; raises ``ValueError`` (naming the
    line) for an entry with no documented reason."""
    entries: Dict[str, str] = {}
    for n, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        entry, sep, reason = line.partition("#")
        entry = entry.strip()
        reason = reason.strip()
        if not sep or not reason:
            raise ValueError(
                f"{origin}:{n}: quarantine entry {entry or raw!r} has no "
                "'# reason' — every quarantined test must document why"
            )
        entries[entry] = reason
    return entries


def load_quarantine(path: str) -> Dict[str, str]:
    """Parse ``path``; a missing file is an empty quarantine (the healthy
    end state), not an error."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        return parse_quarantine_text(fh.read(), origin=path)


def match_quarantine(
    test_ids: List[str], entries: Dict[str, str]
) -> Tuple[Dict[str, str], List[str]]:
    """Split ``test_ids`` into ``({quarantined_id: reason}, remaining)``.

    An entry matches its exact id, or as a ``::``-boundary prefix (a file
    or class entry covers all its tests). Matching is deterministic: the
    first matching entry in file order wins.
    """
    quarantined: Dict[str, str] = {}
    remaining: List[str] = []
    for tid in test_ids:
        reason = None
        for entry, why in entries.items():
            if tid == entry or tid.startswith(entry + "::") or (
                entry.endswith(".py") and tid.startswith(entry + "::")
            ):
                reason = why
                break
        if reason is None:
            remaining.append(tid)
        else:
            quarantined[tid] = reason
    return quarantined, remaining


def unused_entries(test_ids: List[str], entries: Dict[str, str]) -> List[str]:
    """Entries matching no collected test — stale lines that should be
    pruned (a renamed test must not leave its quarantine behind)."""
    stale = []
    for entry in entries:
        if not any(
            tid == entry or tid.startswith(entry + "::") for tid in test_ids
        ):
            stale.append(entry)
    return stale
