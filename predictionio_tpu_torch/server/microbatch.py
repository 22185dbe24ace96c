"""Micro-batching for the serving hot path.

Port of ``predictionio_tpu/server/microbatch.py`` for the threads edge.
Every predict is a device call, and concurrent requests that each launch
their own top-k product queue behind one another on the card.  The
batcher makes concurrency wider instead of deeper: the queries that
arrive while a batch is running are coalesced into ONE
``Algorithm.batch_predict`` call (a ``[B, R] x [R, M]`` product costs
barely more than the ``[R] x [R, M]`` one).

Blocking ``submit(x)`` is the leader/follower pattern: a request appends
its query; if no batch is running it becomes the LEADER and runs
everything pending on its own thread, and requests arriving meanwhile
park as FOLLOWERS.  Under no concurrency this degenerates to a direct
call: no extra thread, no timer.

Deadline-aware admission: entries may carry a :class:`Deadline`.  A
claimed entry already past its deadline completes with
:class:`DeadlineExceeded` without reaching the card, and
:meth:`MicroBatcher.estimate_wait_s` (an EWMA of batch service time)
lets the edge refuse up front, as :class:`AdmissionRejected`, a request
that cannot make its deadline.

Not ported yet: the event-loop edge's continuous ``submit_nowait`` path
and the multi-tenant ``SharedBatcher``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

from ..resilience.policy import Deadline, DeadlineExceeded

__all__ = [
    "AdmissionRejected",
    "EwmaEstimator",
    "MicroBatcher",
    "dispatchable_sizes",
]

logger = logging.getLogger(__name__)

# distinguishes "no result produced" from a legitimate None result
_UNSET = object()


class AdmissionRejected(DeadlineExceeded):
    """The serving edge refused to queue a request that could not make
    its deadline (estimated queue+service time exceeds the remaining
    budget).  A subclass of :class:`DeadlineExceeded` so every 503 path
    handles it; kept distinct so sheds are told from expiries."""


class EwmaEstimator:
    """Exponentially-weighted moving average of observed durations, the
    memory behind deadline-aware admission.  ``0.0`` until the first
    observation, so a cold estimator never sheds.  Not synchronized
    itself: the batcher observes under its condition variable."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.value = 0.0

    def observe(self, dt: float) -> None:
        self.value = (
            dt if self.value <= 0.0
            else self.alpha * dt + (1.0 - self.alpha) * self.value
        )

    def estimate(self) -> float:
        return self.value


def _pad_size(n: int) -> int:
    """The batch size ``n`` items actually dispatch as under pow2
    padding — THE definition; the warmup ladder derives from it."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def dispatchable_sizes(max_batch: int) -> list[int]:
    """Every batch size a padding batcher with this ``max_batch`` can
    dispatch: 1, 2, 4, ..., _pad_size(max_batch); empty when
    ``max_batch <= 0`` (no batcher: every request takes the solo
    predict path)."""
    if max_batch <= 0:
        return []
    top = _pad_size(max_batch)
    b, sizes = 1, []
    while b <= top:
        sizes.append(b)
        b <<= 1
    return sizes


class _Entry:
    __slots__ = ("item", "done", "value", "error", "deadline", "t_enq")

    def __init__(self, item, deadline: Optional[Deadline] = None):
        self.item = item
        self.done = False
        self.value = _UNSET
        self.error: Exception | None = None
        self.deadline = deadline
        self.t_enq = time.perf_counter()


class MicroBatcher:
    """Coalesce concurrent ``submit(x)`` calls into ``batch_fn([x...])``.

    ``batch_fn`` receives a list of items and must return a list of
    results of the same length and order.  An exception from
    ``batch_fn`` on a batch of several items re-runs each item alone, so
    one bad query fails only itself.
    """

    def __init__(
        self,
        batch_fn: Callable[[Sequence[Any]], Sequence[Any]],
        max_batch: int = 64,
        max_wait_s: float = 0.0,
        pad_batches: bool = False,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        # pad each batch to the next power of two by repeating the last
        # item (results sliced off), so the card sees log2(max_batch)+1
        # batch shapes.  Valid only when batch_fn is a pure per-item map,
        # which predicts are.
        self.pad_batches = pad_batches
        self._cond = threading.Condition()
        self._pending: list[_Entry] = []
        self._running = False
        self._ewma = EwmaEstimator()
        self.batches = 0
        self.requests = 0
        self.max_seen = 0
        self.leaders = 0
        self.followers = 0
        self.expired = 0

    def reset_stats(self) -> None:
        with self._cond:
            self.batches = self.requests = self.max_seen = 0
            self.leaders = self.followers = self.expired = 0

    def stats(self) -> dict:
        """Locked snapshot of the coalescing counters and queue depth."""
        with self._cond:
            return {
                "batches": self.batches,
                "requests": self.requests,
                "maxBatchSeen": self.max_seen,
                "leaders": self.leaders,
                "followers": self.followers,
                "expired": self.expired,
                "queueDepth": len(self._pending),
                "ewmaBatchSec": self._ewma.value,
            }

    # -- admission --------------------------------------------------------
    def estimate_wait_s(self) -> float:
        """Estimated queue + service time of a request admitted now:
        (running batch + queued batches ahead + its own) x the EWMA batch
        time; 0.0 until the first batch completes."""
        with self._cond:
            ew = self._ewma.value
            if ew <= 0.0:
                return 0.0
            ahead = 1.0 if self._running else 0.0
            ahead += len(self._pending) / float(self.max_batch)
            return (ahead + 1.0) * ew

    def check_admission(self, deadline: Optional[Deadline]) -> None:
        """Raise :class:`AdmissionRejected` when ``deadline`` cannot be
        met even optimistically."""
        if deadline is None:
            return
        remaining = deadline.remaining()
        if remaining <= 0.0:
            raise AdmissionRejected(
                f"query deadline already exceeded its "
                f"{deadline.budget_s:.3f}s budget at admission"
            )
        est = self.estimate_wait_s()
        if est > remaining:
            raise AdmissionRejected(
                f"estimated queue+service time {est * 1e3:.1f}ms exceeds "
                f"the {remaining * 1e3:.1f}ms remaining of the "
                f"{deadline.budget_s:.3f}s deadline"
            )

    # -- submission -------------------------------------------------------
    def submit(self, item: Any, deadline: Optional[Deadline] = None) -> Any:
        """Blocking submit: returns the result (or raises) on the calling
        thread, leading a batch itself when none is running."""
        entry = _Entry(item, deadline=deadline)
        led_own = False
        with self._cond:
            self._pending.append(entry)
            self._cond.notify_all()
            while not entry.done:
                if not self._running:
                    self._running = True
                    batch = self._pending[: self.max_batch]
                    del self._pending[: len(batch)]
                    # with more than max_batch entries ahead, the claimed
                    # batch may not include our own entry: then we led
                    # for others and stay a follower of a later batch
                    if any(e is entry for e in batch):
                        led_own = True
                    self._lead(batch)
                    continue
                self._cond.wait()
            if led_own:
                self.leaders += 1
            else:
                self.followers += 1
        if entry.error is not None:
            raise entry.error
        return entry.value if entry.value is not _UNSET else None

    def close(self) -> None:
        """Nothing to stop: the threads edge has no dispatcher thread (a
        reload swaps batchers while in-flight queries still hold the old
        one, which keeps working)."""

    def _lead(self, batch: list[_Entry]) -> None:
        """Run one claimed batch on the calling thread.  Called with the
        lock HELD; releases it around the device call.  Entries already
        past their deadline complete with :class:`DeadlineExceeded` and
        never reach the card.  Every claimed entry is marked done even
        when a BaseException tears through, so followers never hang."""
        completed = False
        live: list[_Entry] = []
        n_expired = 0
        for e in batch:
            if e.deadline is not None and e.deadline.expired:
                e.error = DeadlineExceeded(
                    f"query expired in the batch queue after "
                    f"{time.perf_counter() - e.t_enq:.3f}s (budget "
                    f"{e.deadline.budget_s:.3f}s); never dispatched"
                )
                n_expired += 1
            else:
                live.append(e)
        turn_s = 0.0
        try:
            if self.max_wait_s > 0 and live and len(live) < self.max_batch:
                # optional accumulation window (off by default)
                until = time.monotonic() + self.max_wait_s
                while len(live) < self.max_batch:
                    left = until - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                    take = self.max_batch - len(live)
                    absorbed = self._pending[:take]
                    del self._pending[:take]
                    live += absorbed
                    batch += absorbed
            if live:
                self._cond.release()
                t0 = time.perf_counter()
                try:
                    self._exec(live)
                finally:
                    turn_s = time.perf_counter() - t0
                    self._cond.acquire()
            completed = True
        finally:
            for e in batch:
                if not completed and e.value is _UNSET and e.error is None:
                    e.error = RuntimeError(
                        "batch leader aborted before producing results"
                    )
                e.done = True
            self._running = False
            if live:
                self.batches += 1
                self.max_seen = max(self.max_seen, len(live))
                if turn_s > 0.0:
                    self._ewma.observe(turn_s)
            self.requests += len(batch)
            self.expired += n_expired
            self._cond.notify_all()

    def _exec(self, batch: list[_Entry]) -> None:
        """Run one device call; on failure of a batch of several, re-run
        each item alone so only the bad query fails."""
        try:
            items = [e.item for e in batch]
            n = len(items)
            if self.pad_batches and n > 1:
                items = items + [items[-1]] * (_pad_size(n) - n)
            results = self.batch_fn(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results "
                    f"for {len(items)} items"
                )
            for e, r in zip(batch, results):
                e.value = r
        except Exception as exc:  # noqa: BLE001 — propagate per caller
            if len(batch) == 1:
                batch[0].error = exc
                return
            for e in batch:
                try:
                    (r,) = self.batch_fn([e.item])
                    e.value = r
                except Exception as solo:  # noqa: BLE001
                    e.error = solo
