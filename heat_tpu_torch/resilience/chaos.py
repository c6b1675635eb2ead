"""Deterministic fault injection ("chaos") for I/O and collective paths
(counterpart of ``heat_tpu/resilience/chaos.py``).

``with resilience.chaos(seed=0, io_error=0.3):`` installs a seeded injector
into the fault points of :mod:`heat_tpu_torch.core._hooks`: file opens,
writes and commits (``io.*``, through :mod:`heat_tpu_torch.core._atomic`),
the checkpointer's shard writes and reads (``checkpoint.*``), the
collectives (``collective.ragged``/``collective.bucket``/... of every
``flatmove`` move, ``collective.allgather``, ``collective.tree_merge``) and
the guard's shard digests (``guard.shard``). Faults fire from a
``random.Random(seed)`` stream, one draw per fault point hit in program
order (``heat_tpu``'s stream), so a seed gives the same failures on every
run, and the recovery paths (``RetryPolicy``, atomic renames, checksums)
are testable on the CPU.

Fault kinds (independent probabilities, checked in this order against one
uniform draw):

- ``torn_write``: payload sites only: the staged bytes are cut in half and
  an OSError is raised (a crash in the middle of a write);
- ``corrupt``: payload sites: one byte is flipped *silently* past the
  ``.npy`` header, so the file commits and only a checksum can catch it;
  array sites: a NaN is planted in the values;
- ``io_error``: an OSError at the site;
- ``timeout``: a TimeoutError at the site;
- ``straggler``: the site *sleeps* ``straggler_delay`` seconds and goes
  on (the slow peer only a wall-clock deadline,
  :mod:`~heat_tpu_torch.resilience.watchdog`, catches);
- ``divergence``: replica sites only (``guard.shard``, which carries a
  ``replica`` index): the bytes of a NON-primary replica change silently,
  so the replicas' digests disagree (what
  :func:`~heat_tpu_torch.resilience.guard.guarded` must catch);
- ``device_loss``: supervisor and serve sites only (``supervisor.step``,
  ``serve.dispatch``): one healthy rank of the default communicator,
  ``healthy[int(u * 997) % len(healthy)]``, is marked unhealthy
  (:func:`~heat_tpu_torch.resilience.degrade.mark_unhealthy`) and a
  ``RuntimeError`` is raised mid-step: the lost card that only probe +
  ``shrink_to_healthy`` recovers from. Every rank draws the same ``u``
  from its seeded stream, so every rank marks the same rank; with fewer
  than two healthy ranks (one card) it never fires, as in ``heat_tpu``;
- ``device_flap``: device-probe sites only (``monitor.probe``,
  ``degrade.probe``, which carry ``device``): that probe fails once with a
  ``RuntimeError``, the transient flap the health monitor's damping
  absorbs;
- ``straggler_probe``: device-probe sites only: the probe sleeps
  ``straggler_delay`` seconds and goes on (the slow card the monitor's
  EWMA detection catches);
- ``lockstep_divergence`` keeps ``heat_tpu``'s parameter, but its site (the
  lockstep sanitizer of ``heat_tpu``'s ``analysis``) is not ported, so it
  never fires: a scheduled one stays pending.

``max_faults`` caps the number of injected faults, after which every site
passes: ``chaos(io_error=1.0, max_faults=2)`` fails the first two attempts
and lets the third through, the recipe for a transient fault a
``RetryPolicy`` must survive.

:class:`FaultSchedule` is the deterministic complement for recovery proofs:
an explicit list of ``(site, nth_hit, kind)`` events, each fired once when
its site is hit the scheduled number of times. Each process installs its
own injector, so a fault entered on one rank alone fires on that rank only.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import _hooks

__all__ = ["chaos", "Injection", "FaultSchedule"]

# site categories a chaos context can target (site id prefix before ".")
_KNOWN_TARGETS = (
    "io", "collective", "checkpoint", "guard", "degrade", "supervisor",
    "serve", "monitor",
)


@dataclass
class Injection:
    """Record of one injected fault (exposed as ``chaos(...).injected``)."""

    site: str
    kind: str
    detail: str = ""


def _lose_device(u: float) -> Optional[int]:
    """Mark one healthy rank of the default communicator unhealthy; returns
    it, or None when fewer than two ranks are healthy (losing the last card
    would make every recovery impossible by construction)."""
    from . import degrade  # runtime import: chaos sits below degrade's users

    devs = degrade.healthy_devices()
    if len(devs) <= 1:
        return None
    dev = devs[int(u * 997) % len(devs)]
    degrade.mark_unhealthy(dev)
    return int(dev)


@dataclass
class chaos:
    """Context manager injecting deterministic faults; see module docs.

    Parameters
    ----------
    seed : int
        Seeds the fault stream; same seed + same program = same faults.
    io_error, timeout, torn_write, corrupt, straggler, divergence : float
        Per-site probabilities in [0, 1] for each fault kind.
    straggler_delay : float
        Seconds a ``straggler`` (or ``straggler_probe``) fault sleeps
        before the site proceeds.
    targets : sequence of {"io", "collective", "checkpoint", "guard",
        "degrade", "supervisor", "serve", "monitor"}
        Which site categories participate; others always pass.
    max_faults : int, optional
        Stop injecting after this many faults (transient-fault recipe).
    """

    seed: int = 0
    io_error: float = 0.0
    timeout: float = 0.0
    torn_write: float = 0.0
    corrupt: float = 0.0
    straggler: float = 0.0
    divergence: float = 0.0
    device_loss: float = 0.0
    lockstep_divergence: float = 0.0
    device_flap: float = 0.0
    straggler_probe: float = 0.0
    straggler_delay: float = 0.05
    targets: Sequence[str] = _KNOWN_TARGETS
    max_faults: Optional[int] = None
    injected: List[Injection] = field(default_factory=list, init=False)
    draws: int = field(default=0, init=False)

    def __post_init__(self):
        unknown = set(self.targets) - set(_KNOWN_TARGETS)
        if unknown:
            raise ValueError(f"unknown chaos targets {sorted(unknown)}; known: {_KNOWN_TARGETS}")
        for knob in ("io_error", "timeout", "torn_write", "corrupt", "straggler",
                     "divergence", "device_loss", "lockstep_divergence",
                     "device_flap", "straggler_probe"):
            p = getattr(self, knob)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{knob} must be a probability in [0, 1], got {p}")
        if self.straggler_delay < 0:
            raise ValueError(f"straggler_delay must be >= 0, got {self.straggler_delay}")

    # -- context management ------------------------------------------------
    def __enter__(self) -> "chaos":
        self._rng = random.Random(self.seed)
        self.injected = []
        self.draws = 0
        self._prev = _hooks.set_injector(self._inject)
        return self

    def __exit__(self, *exc):
        _hooks.set_injector(self._prev)
        return False

    # -- the injector ------------------------------------------------------
    def _exhausted(self) -> bool:
        return self.max_faults is not None and len(self.injected) >= self.max_faults

    def _inject(self, site: str, ctx: dict) -> None:
        category = site.split(".", 1)[0]
        if category not in self.targets or self._exhausted():
            return
        u = self._rng.random()
        self.draws += 1
        payload = ctx.get("payload")  # bytearray at byte-write sites
        array = ctx.get("array")  # np.ndarray at shard-assembly sites
        threshold = 0.0
        if payload is not None or array is not None:
            threshold += self.torn_write
            if u < threshold and payload is not None:
                cut = max(1, len(payload) // 2)
                del payload[cut:]
                self.injected.append(Injection(site, "torn_write", f"truncated to {cut}B"))
                raise OSError(f"chaos[{site}]: torn write (crashed mid-buffer)")
            threshold += self.corrupt
            if u < threshold:
                if payload is not None and len(payload):
                    # flip a deterministic byte PAST the .npy header so the
                    # file still parses but its checksum no longer matches
                    pos = min(len(payload) - 1, 128 + int(u * 1000) % max(1, len(payload) - 128))
                    payload[pos] ^= 0xFF
                    self.injected.append(Injection(site, "corrupt", f"flipped byte {pos}"))
                elif array is not None and np.issubdtype(array.dtype, np.floating) and array.size:
                    flat = array.reshape(-1)
                    flat[int(u * 1000) % flat.size] = np.nan
                    self.injected.append(Injection(site, "corrupt", "planted NaN"))
                return  # silent corruption: no exception, commit proceeds
        replica = ctx.get("replica")  # replica index at guard.shard sites
        if array is not None and replica is not None and replica != 0 and array.size:
            # divergence: perturb a NON-primary replica's bytes silently, so
            # the replica group digests disagree (primary replicas are left
            # alone — corrupting every copy identically would be undetectable
            # by construction, which is the point of the asymmetry)
            threshold += self.divergence
            if u < threshold:
                view = array.reshape(-1).view(np.uint8)
                pos = int(u * 1000) % view.size
                view[pos] ^= 0xFF
                self.injected.append(
                    Injection(site, "divergence", f"replica {replica} byte {pos}")
                )
                return  # silent: detection is the guard layer's job
        device = ctx.get("device")  # device id at per-device probe sites
        if device is not None:
            threshold += self.device_flap
            if u < threshold:
                self.injected.append(
                    Injection(site, "device_flap", f"device {device}")
                )
                raise RuntimeError(
                    f"chaos[{site}]: device {device} flapped "
                    "(transient probe failure)"
                )
            threshold += self.straggler_probe
            if u < threshold:
                self.injected.append(
                    Injection(site, "straggler_probe", f"slept {self.straggler_delay}s")
                )
                time.sleep(self.straggler_delay)  # slow probe, not a dead one
                return
        threshold += self.io_error
        if u < threshold:
            self.injected.append(Injection(site, "io_error", ""))
            raise OSError(f"chaos[{site}]: injected I/O failure")
        threshold += self.timeout
        if u < threshold:
            self.injected.append(Injection(site, "timeout", ""))
            raise TimeoutError(f"chaos[{site}]: injected timeout")
        threshold += self.straggler
        if u < threshold:
            self.injected.append(
                Injection(site, "straggler", f"slept {self.straggler_delay}s")
            )
            time.sleep(self.straggler_delay)  # then proceed: slow, not dead
            return
        if site.startswith("collective."):
            threshold += self.lockstep_divergence
            if u < threshold:
                if _drop_lockstep_event():
                    self.injected.append(
                        Injection(site, "lockstep_divergence", "dropped recorded event")
                    )
                return  # silent either way: detection is the sanitizer's job
        if site.startswith(("supervisor.", "serve.")):
            threshold += self.device_loss
            if u < threshold:
                dev = _lose_device(u)
                if dev is not None:
                    self.injected.append(Injection(site, "device_loss", f"device {dev}"))
                    raise RuntimeError(
                        f"chaos[{site}]: device {dev} lost (simulated accelerator failure)"
                    )

    # -- reporting ---------------------------------------------------------
    def report(self) -> str:
        lines = [f"chaos(seed={self.seed}): {len(self.injected)} fault(s) in {self.draws} draw(s)"]
        lines += [f"  {i.kind:>10} @ {i.site} {i.detail}".rstrip() for i in self.injected]
        return "\n".join(lines)


def _drop_lockstep_event() -> bool:
    """Whether a ``lockstep_divergence`` fault dropped a recorded event:
    never, since the port has no lockstep sanitizer (``heat_tpu``'s
    ``analysis.lockstep``)."""
    return False


_SCHEDULED_KINDS = (
    "io_error", "timeout", "torn_write", "corrupt", "straggler",
    "divergence", "device_loss", "lockstep_divergence",
    "device_flap", "straggler_probe",
)


def _apply_fault(kind: str, site: str, ctx: dict, u: float, straggler_delay: float) -> Optional[str]:
    """Apply one fault ``kind``'s effect at ``site``. Returns a detail
    string when the fault actually fired, or None when the site cannot
    carry that kind (e.g. a torn write at a payload-less site) — the
    caller keeps the event pending for a later eligible hit."""
    payload = ctx.get("payload")
    array = ctx.get("array")
    replica = ctx.get("replica")
    if kind == "io_error":
        raise OSError(f"chaos[{site}]: injected I/O failure")
    if kind == "timeout":
        raise TimeoutError(f"chaos[{site}]: injected timeout")
    if kind == "straggler":
        time.sleep(straggler_delay)
        return f"slept {straggler_delay}s"
    if kind == "torn_write":
        if payload is None:
            return None
        cut = max(1, len(payload) // 2)
        del payload[cut:]
        detail = f"truncated to {cut}B"
        err = OSError(f"chaos[{site}]: torn write (crashed mid-buffer)")
        err.chaos_detail = detail
        raise err
    if kind == "corrupt":
        if payload is not None and len(payload):
            pos = min(len(payload) - 1, 128 + int(u * 1000) % max(1, len(payload) - 128))
            payload[pos] ^= 0xFF
            return f"flipped byte {pos}"
        if array is not None and np.issubdtype(array.dtype, np.floating) and array.size:
            flat = array.reshape(-1)
            flat[int(u * 1000) % flat.size] = np.nan
            return "planted NaN"
        return None
    if kind == "divergence":
        # only a NON-primary replica diverges (see chaos docs above)
        if array is None or replica in (None, 0) or not array.size:
            return None
        view = array.reshape(-1).view(np.uint8)
        pos = int(u * 1000) % view.size
        view[pos] ^= 0xFF
        return f"replica {replica} byte {pos}"
    if kind == "lockstep_divergence":
        # only collective sites carry lockstep events, and only while a
        # sanitizer is actually recording — otherwise keep the event
        # pending (same contract as a torn write at a payload-less site)
        if not site.startswith("collective.") or not _drop_lockstep_event():
            return None
        return "dropped recorded event"
    if kind == "device_loss":
        dev = _lose_device(u)
        if dev is None:
            return None
        err = RuntimeError(
            f"chaos[{site}]: device {dev} lost (simulated accelerator failure)"
        )
        err.chaos_detail = f"device {dev}"
        raise err
    if kind == "device_flap":
        # only per-device probe sites (monitor.probe / degrade.probe)
        # carry a device id; elsewhere the event stays pending
        device = ctx.get("device")
        if device is None:
            return None
        err = RuntimeError(
            f"chaos[{site}]: device {device} flapped (transient probe failure)"
        )
        err.chaos_detail = f"device {device}"
        raise err
    if kind == "straggler_probe":
        if ctx.get("device") is None:
            return None
        time.sleep(straggler_delay)  # slow probe, not a dead one
        return f"slept {straggler_delay}s"
    raise ValueError(f"unknown scheduled fault kind {kind!r}; known: {_SCHEDULED_KINDS}")


@dataclass
class FaultSchedule:
    """Deterministic fault injection from an explicit event list.

    ``events`` is a sequence of ``(site, nth_hit, kind)`` triples: when the
    fault point ``site`` (exact id, or a prefix ending in ``.``) is hit for
    the ``nth_hit``-th time inside the context, fault ``kind`` fires — once.
    An event whose site cannot carry the kind at that hit (a torn write at
    a payload-less site, a divergence at the primary replica) stays pending
    for the next eligible hit of the same site, so a scheduled fault is
    never silently dropped.

    This is the recovery-*proof* complement of :class:`chaos`: the soak
    harness of ``heat_tpu`` asserts "at least one divergence, one torn write
    were injected AND recovered", which only a guaranteed schedule can
    promise. Same recording surface as chaos:
    ``.injected`` holds one :class:`Injection` per fired event, and
    ``.pending()`` lists events that never found an eligible hit (the soak
    treats a non-empty pending list as a failed proof).
    """

    events: Sequence[Tuple[str, int, str]]
    straggler_delay: float = 0.05
    seed: int = 0
    injected: List[Injection] = field(default_factory=list, init=False)

    def __post_init__(self):
        for site, nth, kind in self.events:
            if kind not in _SCHEDULED_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; known: {_SCHEDULED_KINDS}")
            if nth < 1:
                raise ValueError(f"nth_hit is 1-based, got {nth} for {site!r}")

    def __enter__(self) -> "FaultSchedule":
        self._hits: dict = {}
        self._fired = [False] * len(self.events)
        self._rng = random.Random(self.seed)
        self.injected = []
        self._prev = _hooks.set_injector(self._inject)
        return self

    def __exit__(self, *exc):
        _hooks.set_injector(self._prev)
        return False

    def pending(self) -> List[Tuple[str, int, str]]:
        """Events that have not fired (empty after a complete schedule)."""
        return [e for e, fired in zip(self.events, self._fired) if not fired]

    def _matches(self, pattern: str, site: str) -> bool:
        return site == pattern or (pattern.endswith(".") and site.startswith(pattern))

    def _inject(self, site: str, ctx: dict) -> None:
        hits = self._hits[site] = self._hits.get(site, 0) + 1
        for idx, (pattern, nth, kind) in enumerate(self.events):
            if self._fired[idx] or not self._matches(pattern, site):
                continue
            if hits < nth:
                continue
            # at (or past, for a previously ineligible hit) the scheduled
            # count: try to fire; an ineligible site keeps the event pending
            u = self._rng.random()
            try:
                detail = _apply_fault(kind, site, ctx, u, self.straggler_delay)
            except Exception as err:
                self._fired[idx] = True
                self.injected.append(
                    Injection(site, kind, getattr(err, "chaos_detail", ""))
                )
                raise
            if detail is not None:
                self._fired[idx] = True
                self.injected.append(Injection(site, kind, detail))
            return  # at most one event per hit

    def report(self) -> str:
        lines = [
            f"FaultSchedule: {len(self.injected)}/{len(self.events)} event(s) fired"
        ]
        lines += [f"  {i.kind:>11} @ {i.site} {i.detail}".rstrip() for i in self.injected]
        lines += [f"  PENDING {kind} @ {site} (hit {nth})" for site, nth, kind in self.pending()]
        return "\n".join(lines)
