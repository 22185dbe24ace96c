"""Bounded background delivery queue for fire-and-forget HTTP sends.

Port of ``predictionio_tpu/resilience/delivery.py``: the serving edge's
feedback events and remote error logs leave through it.  A thread per
send would accumulate without bound under heavy traffic with a slow or
dead collector (each holding a socket for its full timeout); here ONE
drain thread works a bounded deque:

* ``submit`` is O(1) and never blocks the hot path; when the queue is
  full the OLDEST entry is dropped (and counted) — fresh telemetry
  beats stale telemetry, and memory stays bounded.
* the drain thread retries each entry with the policy's backoff and
  routes every outcome through a :class:`CircuitBreaker`, so a dead
  endpoint costs one probe per reset interval instead of a connect
  timeout per request.
* an entry is only discarded after delivery or ``max_attempts``
  failures while the breaker was willing — with the breaker OPEN the
  entry waits (no attempts burned), which is what lets events queued
  while the event server was down deliver once it returns.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
import urllib.request
from typing import Optional

from ..obs import (
    BREAKER_STATE,
    BREAKER_STATE_VALUES,
    DELIVERY_DEPTH,
    DELIVERY_TOTAL,
)
from . import faults
from .policy import CircuitBreaker, RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["DeliveryQueue"]


class _Entry:
    __slots__ = ("url", "data", "attempts", "headers")

    def __init__(self, url: str, data: bytes,
                 headers: Optional[dict] = None):
        self.url = url
        self.data = data
        self.attempts = 0
        self.headers = headers or {}


class DeliveryQueue:
    def __init__(
        self,
        name: str,
        capacity: int = 1024,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        timeout_s: float = 2.0,
        fault_point: Optional[str] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self.retry = retry or RetryPolicy(max_attempts=4, base_s=0.1,
                                          cap_s=5.0)
        self.breaker = breaker or CircuitBreaker(failure_threshold=5,
                                                 reset_timeout_s=10.0)
        self.timeout_s = timeout_s
        self.fault_point = fault_point
        self._dq: collections.deque[_Entry] = collections.deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._wake = threading.Event()  # cut breaker/backoff sleeps short
        # counters (read under _cond for a consistent stats() view)
        self.submitted = 0
        self.delivered = 0
        self.dropped = 0
        self.retries = 0
        self.send_failures = 0
        # this queue's breaker state and depth as callback gauges,
        # outcomes as counters.  Gauge children are keyed by queue name:
        # the freshest same-named queue owns the child (one live queue
        # per name per process in the steady state)
        BREAKER_STATE.labels(queue=name).set_function(
            lambda b=self.breaker: BREAKER_STATE_VALUES.get(b.state, -1.0)
        )
        DELIVERY_DEPTH.labels(queue=name).set_function(lambda: self.depth)
        self._m_outcome = {
            k: DELIVERY_TOTAL.labels(queue=name, outcome=k)
            for k in ("submitted", "delivered", "dropped", "retried")
        }

    # -- producer side -----------------------------------------------------
    def submit(self, url: str, payload,
               headers: Optional[dict] = None) -> bool:
        """Enqueue one delivery; returns False when it displaced the
        oldest queued entry (queue at capacity).  ``headers`` are extra
        HTTP headers sent with the POST — trace propagation
        (``X-PIO-Trace``) rides here."""
        data = (payload if isinstance(payload, (bytes, bytearray))
                else json.dumps(payload).encode())
        kept = True
        with self._cond:
            if self._closed:
                self.dropped += 1
                self._m_outcome["dropped"].inc()
                return False
            self.submitted += 1
            self._m_outcome["submitted"].inc()
            if len(self._dq) >= self.capacity:
                self._dq.popleft()
                self.dropped += 1
                self._m_outcome["dropped"].inc()
                kept = False
            self._dq.append(_Entry(url, data, headers))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True,
                    name=f"delivery-{self.name}",
                )
                self._thread.start()
            self._cond.notify()
        return kept

    # -- drain thread ------------------------------------------------------
    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._dq and not self._closed:
                    self._cond.wait()
                if self._closed and not self._dq:
                    return
                entry = self._dq[0]  # keep queued until resolved
            if not self.breaker.allow():
                # open breaker: hold position, nap, re-check (a probe
                # slot frees when the reset timeout passes)
                self._wake.wait(min(0.05, self.breaker.reset_timeout_s))
                self._wake.clear()
                if self._closed_now():
                    return
                continue
            try:
                self._send(entry)
            except Exception as e:
                self.breaker.record_failure()
                entry.attempts += 1
                with self._cond:
                    self.send_failures += 1
                    if entry.attempts >= self.retry.max_attempts:
                        # undeliverable: give its slot to fresher data
                        if self._dq and self._dq[0] is entry:
                            self._dq.popleft()
                        self.dropped += 1
                        self._m_outcome["dropped"].inc()
                        logger.warning(
                            "%s delivery dropped after %d attempts: %s",
                            self.name, entry.attempts, e,
                        )
                        continue
                    self.retries += 1
                    self._m_outcome["retried"].inc()
                self._wake.wait(self.retry.backoff(entry.attempts))
                self._wake.clear()
                if self._stopping():
                    return
            else:
                self.breaker.record_success()
                with self._cond:
                    if self._dq and self._dq[0] is entry:
                        self._dq.popleft()
                    self.delivered += 1
                    self._m_outcome["delivered"].inc()
                    self._cond.notify_all()  # flush() waiters

    def _closed_now(self) -> bool:
        with self._cond:
            return self._closed

    def _stopping(self) -> bool:
        # closed AND drained, read atomically — the drain thread checks
        # this off-lock after a backoff nap
        with self._cond:
            return self._closed and not self._dq

    def _send(self, entry: _Entry) -> None:
        if self.fault_point is not None:
            faults.check(self.fault_point)
        req = urllib.request.Request(
            entry.url, data=entry.data,
            headers={"Content-Type": "application/json", **entry.headers},
            method="POST",
        )
        # context manager: the response socket must close on every path
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            r.read()

    # -- lifecycle / observability ----------------------------------------
    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the queue drains (True) or the timeout passes
        (False).  A test and shutdown helper, never on the hot path."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._dq:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
            return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._wake.set()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._dq)

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": len(self._dq),
                "capacity": self.capacity,
                "submitted": self.submitted,
                "delivered": self.delivered,
                "dropped": self.dropped,
                "retries": self.retries,
                "sendFailures": self.send_failures,
                "breaker": self.breaker.snapshot(),
            }
