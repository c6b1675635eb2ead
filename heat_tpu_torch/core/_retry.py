"""Retry with backoff for the I/O entry points (counterpart of
``heat_tpu/core/_retry.py``).

:func:`heat_tpu_torch.load` and :func:`heat_tpu_torch.save` take a
``retry=`` :class:`RetryPolicy` and rerun the whole read or write on a
transient ``OSError``/``TimeoutError``; the default, :data:`NO_RETRY`, is
one attempt. The backoff is exponential with a jitter drawn from a
seeded stream, so a seeded policy sleeps the same on every rank and in
every run. When every attempt fails, one :class:`RetryError` carries the
whole history.
"""
from __future__ import annotations

import random as _random
import time as _time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Type

__all__ = ["RetryPolicy", "RetryError", "NO_RETRY"]


class RetryError(OSError):
    """Terminal retry failure: every attempt allowed by the policy failed.

    Subclasses :class:`OSError` so callers that guard an I/O path with
    ``except OSError`` see the terminal failure the same way whether a
    retry policy was in force or not.

    Attributes
    ----------
    attempts : list of (attempt_index, exception, delay_before_next)
        Full history; ``delay_before_next`` is None for the last attempt.
    last : BaseException
        The exception of the final attempt (also the ``__cause__``).
    """

    def __init__(self, label: str, attempts: List[Tuple[int, BaseException, Optional[float]]]):
        self.attempts = attempts
        self.last = attempts[-1][1] if attempts else None
        lines = [
            f"{label}: failed after {len(attempts)} attempt(s):"
        ]
        for i, exc, delay in attempts:
            suffix = "giving up" if delay is None else f"retried after {delay:.3f}s"
            lines.append(f"  attempt {i + 1}: {type(exc).__name__}: {exc} ({suffix})")
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter (capped), applied to transient errors.

    Parameters
    ----------
    max_attempts : int
        Total attempts (1 = no retry).
    base_delay : float
        Delay before the 2nd attempt, in seconds.
    max_delay : float
        Hard cap on any single delay (backoff + jitter never exceeds it).
    multiplier : float
        Backoff growth factor per attempt.
    jitter : float
        Max fraction of the backoff added as random jitter (0.1 = +10%).
    retry_on : tuple of exception types
        Only these are retried; anything else propagates immediately.
    seed : int, optional
        Seeds the jitter stream for reproducible delay sequences.
    max_elapsed : float, optional
        Total wall-clock budget in seconds across ALL attempts. A retry
        whose backoff sleep would carry the elapsed time past the budget
        is not taken: the policy gives up immediately with a
        :class:`RetryError` instead. This bounds the worst case of a
        retry storm — a supervised step's retries can never outlast its
        checkpoint interval. ``None`` (default) means unbounded.
    sleep : callable
        Injection point for tests (defaults to ``time.sleep``).
    clock : callable
        Monotonic-time source for the ``max_elapsed`` budget (injection
        point for tests; defaults to ``time.monotonic``).
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    retry_on: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)
    seed: Optional[int] = None
    max_elapsed: Optional[float] = None
    sleep: Callable[[float], None] = field(default=_time.sleep, repr=False)
    clock: Callable[[], float] = field(default=_time.monotonic, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be non-negative")
        if self.max_elapsed is not None and self.max_elapsed < 0:
            raise ValueError(f"max_elapsed must be >= 0, got {self.max_elapsed}")

    def delays(self) -> List[float]:
        """The (deterministic given ``seed``) delay schedule: one entry per
        retry, i.e. ``max_attempts - 1`` values."""
        rng = _random.Random(self.seed)
        out = []
        for i in range(self.max_attempts - 1):
            backoff = self.base_delay * (self.multiplier**i)
            d = backoff * (1.0 + self.jitter * rng.random())
            out.append(min(d, self.max_delay))
        return out

    def call(self, fn: Callable, *args, label: Optional[str] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy.

        Retries on ``retry_on`` exceptions up to ``max_attempts`` total
        tries with backoff between them; raises :class:`RetryError` (with
        the attempt history, chained to the last failure) when exhausted.
        """
        label = label or getattr(fn, "__name__", "operation")
        attempts: List[Tuple[int, BaseException, Optional[float]]] = []
        schedule = self.delays()
        t0 = self.clock()
        for i in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                delay = schedule[i] if i < len(schedule) else None
                if delay is not None and self.max_elapsed is not None:
                    # a sleep that would carry us past the budget is never
                    # taken: give up NOW, so a retry storm is bounded by
                    # max_elapsed rather than by the full attempt schedule
                    if (self.clock() - t0) + delay > self.max_elapsed:
                        attempts.append((i, exc, None))
                        err = RetryError(
                            f"{label} (wall-clock budget max_elapsed="
                            f"{self.max_elapsed}s exhausted)",
                            attempts,
                        )
                        raise err from exc
                attempts.append((i, exc, delay))
                if delay is None:
                    err = RetryError(label, attempts)
                    raise err from exc
                self.sleep(delay)

    def wrap(self, fn: Callable, label: Optional[str] = None) -> Callable:
        """Decorator form of :meth:`call`."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, label=label, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


# the no-op policy: io.py wires retries through this by default so
# behavior is unchanged unless the caller (or checkpoint I/O) opts in
NO_RETRY = RetryPolicy(max_attempts=1)
