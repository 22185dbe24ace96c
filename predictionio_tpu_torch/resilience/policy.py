"""Retry, deadline, and circuit-breaker primitives.

Copy of ``predictionio_tpu/resilience/policy.py`` for the port, with
``RetryPolicy.backoff``'s exponent capped (the reference's overflows
after 646 attempts).  Pure stdlib, no package-internal imports: every
other layer (server, storage, workflow) may depend on this module
without cycles.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "RetryPolicy",
    "Deadline",
    "DeadlineExceeded",
    "CircuitBreaker",
    "deadline_scope",
    "current_deadline",
    "check_deadline",
]


class RetryPolicy:
    """Exponential backoff with decorrelated jitter.

    ``max_attempts`` counts the first try: 3 means one call plus up to
    two retries.  Delays follow the decorrelated-jitter scheme
    (AWS architecture blog): ``d_0 = base``, ``d_n = min(cap,
    uniform(base, 3 * d_{n-1}))`` — successive waiters spread out
    instead of thundering back in lockstep.  A ``seed`` pins the jitter
    RNG so a fault-injection test observes the exact same delay
    sequence on every run.
    """

    def __init__(self, max_attempts: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0, seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def delays(self) -> Iterator[float]:
        """The backoff sequence for one call: ``max_attempts - 1``
        sleeps."""
        prev = self.base_s
        for _ in range(self.max_attempts - 1):
            with self._lock:  # Random() is not thread-safe for streams
                d = min(self.cap_s,
                        self._rng.uniform(self.base_s, prev * 3))
            prev = max(d, self.base_s)
            yield d

    def backoff(self, attempt: int) -> float:
        """Stateless jittered delay for a caller tracking its own
        attempt count (attempt 1 = first failure), for consumers like
        the delivery drain thread whose retries interleave across many
        queued entries."""
        # the exponent is capped: 3**646 no longer converts to a float,
        # and the delay is at its cap long before
        hi = min(self.cap_s,
                 self.base_s * (3 ** min(max(0, attempt - 1), 64)))
        with self._lock:
            return self._rng.uniform(self.base_s, max(self.base_s, hi))

    def call(
        self,
        fn: Callable[[], Any],
        retry_on: tuple = (Exception,),
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ) -> Any:
        """Run ``fn`` with retries on ``retry_on`` exceptions.

        The final failure re-raises unwrapped, so callers' existing
        except clauses keep working.  A deadline in scope bounds the
        whole retry loop: once the budget cannot cover the next sleep,
        the last error surfaces instead of sleeping past it.
        """
        delays = self.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on as e:
                d = next(delays, None)
                if d is None:
                    raise
                dl = current_deadline()
                if dl is not None and dl.remaining() <= d:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(d)


class DeadlineExceeded(TimeoutError):
    """A propagated time budget ran out before the operation finished."""


class Deadline:
    """A fixed point in (monotonic) time that work must finish by.

    Created once per request and consulted at the expensive boundaries
    (storage access, device dispatch) so an overloaded server answers a
    structured 503 instead of queueing unbounded work behind a client
    that already gave up.
    """

    __slots__ = ("expires_at", "budget_s", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = budget_s
        self._clock = clock
        self.expires_at = clock() + budget_s

    @classmethod
    def after(cls, budget_s: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget_s, clock)

    def remaining(self) -> float:
        return self.expires_at - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"{what} exceeded its {self.budget_s:.3f}s deadline"
            )


_scope = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Propagate ``deadline`` to everything on this thread inside the
    scope (storage methods call :func:`check_deadline` without any
    plumbing through intermediate signatures).  ``None`` is a no-op
    scope so call sites don't need to branch."""
    prev = getattr(_scope, "deadline", None)
    _scope.deadline = deadline if deadline is not None else prev
    try:
        yield deadline
    finally:
        _scope.deadline = prev


def current_deadline() -> Optional[Deadline]:
    return getattr(_scope, "deadline", None)


def check_deadline(what: str = "operation") -> None:
    """Raise :class:`DeadlineExceeded` if the scope's budget ran out.
    One thread-local read when no deadline is set — cheap enough for
    per-call placement on hot paths."""
    dl = getattr(_scope, "deadline", None)
    if dl is not None:
        dl.check(what)


class CircuitBreaker:
    """Closed / open / half-open breaker for one dependency.

    After ``failure_threshold`` consecutive failures the breaker opens:
    :meth:`allow` answers False (callers skip the doomed I/O) until
    ``reset_timeout_s`` elapses, then exactly one probe is let through
    (half-open).  A probe success closes the breaker; a probe failure
    re-opens it for another timeout.  This is what stops a dead event
    server or log collector from consuming a send attempt (and its
    timeout) per request forever.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self.open_count = 0  # lifetime transitions into OPEN

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        # lock held; does NOT claim the half-open probe slot
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            return self.HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """Whether a call may proceed now.  In the open state, the
        first allow() after the reset timeout claims the single
        half-open probe; concurrent callers keep getting False until
        the probe reports."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    return True
                return False
            return False  # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if (self._state == self.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    self.open_count += 1
                self._state = self.OPEN
                self._opened_at = self._clock()

    def snapshot(self) -> dict:
        """Status-JSON view."""
        with self._lock:
            return {
                "state": self._peek_state(),
                "consecutiveFailures": self._consecutive_failures,
                "openCount": self.open_count,
                "failureThreshold": self.failure_threshold,
                "resetTimeoutSec": self.reset_timeout_s,
            }
