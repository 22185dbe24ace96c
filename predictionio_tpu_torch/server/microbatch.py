"""Continuous micro-batching for the serving hot path.

Port of ``predictionio_tpu/server/microbatch.py``.  Every predict is a
device call, and concurrent requests that each launch their own top-k
product queue behind one another on the card.  The batcher makes
concurrency wider instead of deeper: the queries that arrive while a
batch is running are coalesced into ONE ``Algorithm.batch_predict`` call
(a ``[B, R] x [R, M]`` product costs barely more than the ``[R] x [R, M]``
one).  Two submission paths share one pending queue and one claim/run
core:

* blocking ``submit(x)`` (the threads edge), the leader/follower
  pattern: a request appends its query; if no batch is running and no
  dispatcher owns the queue it becomes the LEADER and runs everything
  pending on its own thread, and requests arriving meanwhile park as
  FOLLOWERS.  Under no concurrency this is a direct call;
* continuous ``submit_nowait(x, on_done)`` (the event-loop edge): the
  entry joins the pending queue and the call returns; a lazily started
  dispatcher thread claims whatever is pending the moment the card is
  free and fires each entry's callback.  No thread parks per request.

:class:`SharedBatcher` is one such core for every tenant of a server,
claimed by weighted deficit round-robin across tenants;
:class:`SharedBatcherView` is one tenant's handle on it.

Deadline-aware admission: entries may carry a :class:`Deadline`.  A
claimed entry already past its deadline completes with
:class:`DeadlineExceeded` without reaching the card, and
:meth:`MicroBatcher.estimate_wait_s` (an EWMA of batch service time)
lets the edge refuse up front, as :class:`AdmissionRejected`, a request
that cannot make its deadline.

Observability is the reference's: the saturation families
(``pio_microbatch_*``), the ``microbatch`` timed condition, and each
entry's enqueue/claim/run stamps credited to the request's pulse
timeline (``_book_timeline``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

from ..obs.scope import TimedCondition, register_thread_role
from ..obs.timeline import (
    MICROBATCH_ADMISSION_TOTAL,
    MICROBATCH_BATCH_SIZE,
    MICROBATCH_QUEUE_DEPTH,
    MICROBATCH_ROLE_TOTAL,
    MICROBATCH_TENANTS_PER_BATCH,
    MICROBATCH_WAIT_SECONDS,
    annotate,
    current_timeline,
)
from ..resilience.policy import Deadline, DeadlineExceeded

__all__ = [
    "AdmissionRejected",
    "EwmaEstimator",
    "MicroBatcher",
    "SharedBatcher",
    "SharedBatcherView",
    "dispatchable_sizes",
]

logger = logging.getLogger(__name__)

# pulse saturation metrics, children cached at import (labels() is too
# hot for the per-submit path); process-wide like pio_query_latency
_m_queue_depth = MICROBATCH_QUEUE_DEPTH.child()
_m_batch_size = MICROBATCH_BATCH_SIZE.child()
_m_batch_wait = MICROBATCH_WAIT_SECONDS.child()
_m_leader = MICROBATCH_ROLE_TOTAL.labels(role="leader")
_m_follower = MICROBATCH_ROLE_TOTAL.labels(role="follower")
_m_dispatched = MICROBATCH_ROLE_TOTAL.labels(role="dispatched")
_m_adm_rejected = MICROBATCH_ADMISSION_TOTAL.labels(outcome="rejected")
_m_adm_expired = MICROBATCH_ADMISSION_TOTAL.labels(outcome="expired")
_m_tenants_per_batch = MICROBATCH_TENANTS_PER_BATCH.child()

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
    # tenant/fn are the shared-batcher fields: which tenant the entry
    # belongs to (the round-robin claim key) and which batch_fn runs it
    # (entries sharing a fn coalesce into ONE device call; None means the
    # owning batcher's own batch_fn).  An entry carries its fn for its
    # whole life, so in-flight queries complete on the model they
    # snapshotted even across a reload.  t_enq/t_claim/t_run0/t_run1
    # are the pulse timeline stamps, set by whichever thread performs
    # the transition and read after ``done`` (the condition variable or
    # the dispatcher's post-batch callback orders the writes first).
    __slots__ = ("item", "done", "value", "error", "deadline", "tl",
                 "on_done", "tenant", "fn", "cb_fired",
                 "t_enq", "t_claim", "t_run0", "t_run1")

    def __init__(self, item, deadline: Optional[Deadline] = None,
                 tl=None, on_done: Optional[Callable] = None,
                 tenant=None, fn: Optional[Callable] = None):
        self.item = item
        self.done = False
        self.cb_fired = False
        self.value = _UNSET
        self.error: Exception | None = None
        self.deadline = deadline
        self.tl = tl
        self.on_done = on_done
        self.tenant = tenant
        self.fn = fn
        self.t_enq = time.perf_counter()
        self.t_claim = None
        self.t_run0 = None
        self.t_run1 = None


class MicroBatcher:
    """Coalesce concurrent ``submit(x)`` / ``submit_nowait(x, cb)`` calls
    into ``batch_fn([x...])``.

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
        # pio-scope: the serving hot lock; its wait histogram is the
        # direct queueing-for-the-batcher evidence
        self._cond = TimedCondition("microbatch")
        self._pending: list[_Entry] = []
        self._running = False
        self._closed = False
        self._dispatcher_alive = False
        self._dispatcher: Optional[threading.Thread] = None
        self._ewma = EwmaEstimator()
        # full service time of the last leader turn (every execution
        # group back to back): what the EWMA observes
        self._turn_s = 0.0
        self.batches = 0
        self.requests = 0
        self.max_seen = 0
        self.leaders = 0
        self.followers = 0
        self.dispatched = 0
        self.expired = 0

    def reset_stats(self) -> None:
        with self._cond:
            self.batches = self.requests = self.max_seen = 0
            self.leaders = self.followers = 0
            self.dispatched = self.expired = 0

    def stats(self) -> dict:
        """Locked snapshot of the coalescing counters and queue depth."""
        with self._cond:
            return {
                "batches": self.batches,
                "requests": self.requests,
                "maxBatchSeen": self.max_seen,
                "leaders": self.leaders,
                "followers": self.followers,
                "dispatched": self.dispatched,
                "expired": self.expired,
                "queueDepth": len(self._pending),
                "dispatcher": self._dispatcher_alive,
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
            _m_adm_rejected.inc()
            raise AdmissionRejected(
                f"query deadline already exceeded its "
                f"{deadline.budget_s:.3f}s budget at admission"
            )
        est = self.estimate_wait_s()
        if est > remaining:
            _m_adm_rejected.inc()
            raise AdmissionRejected(
                f"estimated queue+service time {est * 1e3:.1f}ms exceeds "
                f"the {remaining * 1e3:.1f}ms remaining of the "
                f"{deadline.budget_s:.3f}s deadline"
            )

    # -- submission paths -------------------------------------------------
    def submit(self, item: Any, deadline: Optional[Deadline] = None,
               tenant=None, fn: Optional[Callable] = None) -> Any:
        """Blocking submit: returns the result (or raises) on the calling
        thread.  With no dispatcher running the caller leads a batch
        itself when none is running; with one, it parks as a follower of
        the dispatcher's batches.  ``tenant``/``fn`` are the shared
        batcher's routing fields (see :class:`SharedBatcherView`)."""
        entry = _Entry(item, deadline=deadline, tenant=tenant, fn=fn)
        led_own = False
        with self._cond:
            self._pending.append(entry)
            _m_queue_depth.set(float(len(self._pending)))
            # wake a leader or dispatcher in its accumulation window
            self._cond.notify_all()
            while not entry.done:
                if not self._running and not self._dispatcher_alive:
                    self._running = True
                    batch = self._claim_locked()
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
        (_m_leader if led_own else _m_follower).inc()
        # credit the caller's pulse timeline with what this entry
        # actually experienced (error requests decompose too)
        self._book_timeline(entry)
        if entry.error is not None:
            raise entry.error
        return entry.value if entry.value is not _UNSET else None

    def submit_nowait(self, item: Any, on_done: Callable[[_Entry], None],
                      deadline: Optional[Deadline] = None,
                      timeline=None, tenant=None,
                      fn: Optional[Callable] = None) -> None:
        """Continuous (callback) submit: the entry joins the pending
        queue at once and ``on_done(entry)`` fires on the dispatcher
        thread, after the entry's timeline is booked, once
        ``entry.value``/``entry.error`` is set.  The lazily
        started dispatcher claims the next batch the moment the card is
        free, so arrivals ride the NEXT device call.  Raises
        ``RuntimeError`` once the batcher is closed."""
        entry = _Entry(item, deadline=deadline, tl=timeline,
                       on_done=on_done, tenant=tenant, fn=fn)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if not self._dispatcher_alive:
                self._dispatcher_alive = True
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True,
                    name="microbatch-dispatch",
                )
                self._dispatcher.start()
            self._pending.append(entry)
            _m_queue_depth.set(float(len(self._pending)))
            self._cond.notify_all()

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting ``submit_nowait`` work, let the dispatcher
        drain what is pending, and wait (up to ``timeout_s``) for it to
        exit: a thread that ran device work must not outlive its server,
        or the interpreter's exit can catch it in native code.  Blocking
        ``submit`` keeps working (self-led): a reload swaps batchers
        while in-flight queries still hold the old one."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            dispatcher = self._dispatcher
        if (dispatcher is not None
                and dispatcher is not threading.current_thread()):
            dispatcher.join(timeout_s)

    # -- claim/run core (shared by leaders and the dispatcher) ------------
    def _claim_locked(self) -> list[_Entry]:
        batch = self._pending[: self.max_batch]
        del self._pending[: len(batch)]
        now = time.perf_counter()
        for e in batch:
            e.t_claim = now
        _m_queue_depth.set(float(len(self._pending)))
        return batch

    def _dispatch_loop(self) -> None:
        """Standing leader of the continuous path: claims pending
        entries whenever the card is free.  Blocking submitters coalesce
        into its batches as followers."""
        register_thread_role("microbatch_dispatcher")
        with self._cond:
            try:
                while True:
                    while not self._pending and not self._closed:
                        self._cond.wait()
                    if not self._pending and self._closed:
                        break
                    if self._running:
                        # a blocking leader beat us to the claim
                        self._cond.wait()
                        continue
                    self._running = True
                    batch = self._claim_locked()
                    try:
                        self._lead(batch)
                    except Exception:
                        # _lead's finally already completed the batch;
                        # the dispatcher itself must survive (a dead one
                        # would wedge every later submit)
                        logger.exception("microbatch dispatcher error")
                    # the entries carry their tenant's batch_fn (and so
                    # its model): holding them while idle would keep an
                    # evicted tenant's tensors alive until the next claim
                    del batch
            finally:
                self._dispatcher_alive = False
                self._cond.notify_all()

    def _book_timeline(self, entry: _Entry) -> None:
        """Book queue_wait/batch_wait/device from the entry stamps onto
        the entry's attached timeline (continuous path) or the calling
        thread's current one (blocking path).  Residual time inside the
        covered region (condition wake latency, a solo retry after a
        failed batch) goes to ``device``, so the segments still sum to
        the wall time."""
        tl = entry.tl if entry.tl is not None else current_timeline()
        if tl is None:
            return
        parts = []
        if entry.t_claim is not None:
            parts.append(("queue_wait", entry.t_claim - entry.t_enq))
            if entry.t_run0 is not None:
                parts.append(("batch_wait", entry.t_run0 - entry.t_claim))
                if entry.t_run1 is not None:
                    parts.append(("device", entry.t_run1 - entry.t_run0))
        tl.add_block(parts, residual_to="device")

    def _lead(self, batch: list[_Entry]) -> None:
        """Run one claimed batch on the calling thread.  Called with the
        lock HELD; releases it around the device call (and around
        continuous-path callbacks) and re-acquires.  Entries already past
        their deadline complete with :class:`DeadlineExceeded` and never
        reach the card.  Every claimed entry is marked done (and its
        callback fired) even when a BaseException tears through, so
        followers and event-loop requests never hang."""
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
        if n_expired:
            _m_adm_expired.inc(n_expired)
        try:
            if self.max_wait_s > 0 and live and len(live) < self.max_batch:
                # optional accumulation window (off by default): absorb
                # after every wake so nothing queued during the window is
                # left for the next leader
                until = time.monotonic() + self.max_wait_s
                while len(live) < self.max_batch:
                    left = until - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                    take = self.max_batch - len(live)
                    absorbed = self._pending[:take]
                    del self._pending[:take]
                    if absorbed:
                        now = time.perf_counter()
                        for e in absorbed:
                            e.t_claim = now
                        live += absorbed
                        batch += absorbed
                        _m_queue_depth.set(float(len(self._pending)))
            if live:
                self._cond.release()
                try:
                    self._run_batch(live)
                finally:
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
                if self._turn_s > 0.0:
                    self._ewma.observe(self._turn_s)
                    self._turn_s = 0.0
            self.requests += len(batch)
            self.expired += n_expired
            n_disp = sum(1 for e in batch if e.on_done is not None)
            if n_disp:
                self.dispatched += n_disp
                _m_dispatched.inc(n_disp)
            self._cond.notify_all()
            # callbacks _run_batch did not fire: claim-time expiries and
            # whatever a BaseException tore past
            cbs = [e for e in batch
                   if e.on_done is not None and not e.cb_fired]
            if cbs:
                self._cond.release()
                try:
                    self._fire_callbacks(cbs)
                finally:
                    self._cond.acquire()

    def _group(self, batch: list[_Entry]) -> list:
        """Partition a claimed batch into execution groups
        ``[(batch_fn, entries)]``: one group (the batcher's own fn) for a
        plain batcher, one per carried fn for the shared batcher."""
        by_fn: dict = {}
        for e in batch:
            k = id(e.fn) if e.fn is not None else 0
            g = by_fn.get(k)
            if g is None:
                g = by_fn[k] = (
                    e.fn if e.fn is not None else self.batch_fn, [])
            g[1].append(e)
        return list(by_fn.values())

    def _run_batch(self, batch: list[_Entry]) -> None:
        """Execute one claimed batch as its execution groups, each
        group's callbacks firing as soon as its device call returns;
        times the whole turn.  Runs WITHOUT the lock."""
        t0 = time.perf_counter()
        for fn, entries in self._group(batch):
            self._exec_group(fn, entries)
            self._fire_callbacks(entries)
        self._turn_s = max(time.perf_counter() - t0, 0.0)

    def _fire_callbacks(self, entries: list[_Entry]) -> None:
        """Fire the continuous-path callbacks of executed entries, once
        each (``cb_fired``).  A raising callback is logged and does not
        stop the others.  Called WITHOUT the lock: callbacks enqueue
        response bytes to the event loop."""
        for e in entries:
            if e.on_done is None or e.cb_fired:
                continue
            e.cb_fired = True
            self._book_timeline(e)
            try:
                e.on_done(e)
            except Exception:
                logger.exception("microbatch completion callback failed")

    def _exec_group(self, fn: Callable, batch: list[_Entry]) -> None:
        """Run one device call; on failure of a batch of several, re-run
        each item alone so only the bad query fails."""
        try:
            items = [e.item for e in batch]
            n = len(items)
            if self.pad_batches and n > 1:
                items = items + [items[-1]] * (_pad_size(n) - n)
            t0 = time.perf_counter()
            for e in batch:
                e.t_run0 = t0
            if batch[0].t_claim is not None:
                # accumulation-window cost: first claim -> dispatch
                _m_batch_wait.observe(max(t0 - batch[0].t_claim, 0.0))
            _m_batch_size.observe(float(n))
            with annotate(f"pio.device.batch{len(items)}"):
                results = fn(items)
            t1 = time.perf_counter()
            for e in batch:
                e.t_run1 = t1
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
                    (r,) = fn([e.item])
                    e.value = r
                except Exception as solo:  # noqa: BLE001
                    e.error = solo


class SharedBatcher(MicroBatcher):
    """ONE continuous batcher for every tenant of a server.

    It keeps the claim/run core of :class:`MicroBatcher` (one pending
    queue, one lazily started dispatcher, the leader/follower blocking
    path) and changes who gets claimed:

    * claim-time weighted deficit round-robin across tenants: each claim
      walks the tenants with pending entries in rotation order; every
      round a tenant's deficit grows by its weight (normalized to the
      largest active weight, floored at ``MIN_SHARE``) and each whole
      unit of deficit buys one entry.  FIFO order holds within a tenant.
      A claim with one tenant pending is a plain FIFO claim;
    * group-keyed execution: entries carry their tenant's ``batch_fn``;
      entries sharing a fn coalesce into one padded device call, and
      distinct models run back to back in the same dispatcher turn.

    Weights are pulled at claim time through per-tenant ``weight_fn``
    callbacks, or pushed with :meth:`set_weights`.
    """

    # floor on a tenant's relative claim share: even a weight-0 tenant
    # drains, and the round-robin loop is bounded (<= 20 rounds a claim)
    MIN_SHARE = 0.05

    def __init__(self, max_batch: int = 64, max_wait_s: float = 0.0,
                 pad_batches: bool = True):
        # no default batch_fn: every entry must carry its tenant's fn
        def _no_fn(items):
            raise RuntimeError(
                "SharedBatcher entries must carry a batch_fn "
                "(submit via a SharedBatcherView)"
            )

        super().__init__(_no_fn, max_batch=max_batch,
                         max_wait_s=max_wait_s, pad_batches=pad_batches)
        # all guarded by _cond, like every other mutable field
        self._weights: dict = {}
        self._weight_fns: dict = {}
        self._reg_counts: dict = {}
        self._deficit: dict = {}
        self._rr: list = []
        self.mixed_batches = 0
        self.tenant_claims: dict = {}

    # -- tenant lifecycle -------------------------------------------------
    def register_tenant(self, tenant, weight: float = 1.0,
                        weight_fn: Optional[Callable] = None) -> None:
        """A view's registration.  Counted per tenant key: a reload
        registers the NEW view before closing the old one, and the
        tenant's scheduling state survives the overlap."""
        with self._cond:
            self._reg_counts[tenant] = self._reg_counts.get(tenant, 0) + 1
            self._weights[tenant] = float(weight)
            if weight_fn is not None:
                self._weight_fns[tenant] = weight_fn
            if tenant not in self._rr:
                self._rr.append(tenant)

    def retire_tenant(self, tenant) -> None:
        """Drop a tenant's scheduling state once its LAST view closes.
        Entries it already enqueued still complete: they carry their
        own fn."""
        with self._cond:
            n = self._reg_counts.get(tenant, 0) - 1
            if n > 0:
                self._reg_counts[tenant] = n
                return
            self._reg_counts.pop(tenant, None)
            self._weights.pop(tenant, None)
            self._weight_fns.pop(tenant, None)
            self._deficit.pop(tenant, None)
            if tenant in self._rr:
                self._rr.remove(tenant)

    def set_weights(self, weights: dict) -> None:
        with self._cond:
            for t, w in weights.items():
                self._weights[t] = float(w)

    def _weight_of_locked(self, tenant) -> float:
        fn = self._weight_fns.get(tenant)
        if fn is not None:
            try:
                w = float(fn())
                if w > 0.0:
                    return w
            except Exception:
                logger.exception("weight_fn for tenant %r failed", tenant)
        w = self._weights.get(tenant, 1.0)
        return w if w > 0.0 else 0.0

    # -- claim policy -----------------------------------------------------
    def _claim_locked(self) -> list[_Entry]:
        pend = self._pending
        if not pend:
            return []
        by_tenant: dict = {}
        for e in pend:
            by_tenant.setdefault(e.tenant, []).append(e)
        if len(by_tenant) == 1:
            # one tenant pending: plain FIFO, no round-robin work
            batch = super()._claim_locked()
            _m_tenants_per_batch.observe(1.0)
            t0 = batch[0].tenant
            self.tenant_claims[t0] = self.tenant_claims.get(t0, 0) + len(batch)
            return batch
        # rotation order: registration order, rotated one step a claim so
        # no tenant always goes first; unregistered tenants append
        for t in by_tenant:
            if t not in self._rr:
                self._rr.append(t)
        walk = [t for t in self._rr if t in by_tenant]
        weights = {t: self._weight_of_locked(t) for t in walk}
        wmax = max(weights.values()) or 1.0
        share = {t: max(weights[t] / wmax, self.MIN_SHARE) for t in walk}
        deficit = self._deficit
        batch: list[_Entry] = []
        room = self.max_batch
        while room > 0 and any(by_tenant[t] for t in walk):
            for t in walk:
                q = by_tenant[t]
                if not q:
                    # an empty queue forfeits its deficit (banked credit
                    # would burst later instead of smoothing)
                    deficit.pop(t, None)
                    continue
                d = deficit.get(t, 0.0) + share[t]
                while q and room > 0 and d >= 1.0:
                    batch.append(q.pop(0))
                    d -= 1.0
                    room -= 1
                deficit[t] = d
                if room <= 0:
                    break
        claimed = {id(e) for e in batch}
        self._pending = [e for e in pend if id(e) not in claimed]
        now = time.perf_counter()
        tenants_seen = set()
        for e in batch:
            e.t_claim = now
            tenants_seen.add(e.tenant)
            self.tenant_claims[e.tenant] = (
                self.tenant_claims.get(e.tenant, 0) + 1
            )
        if len(tenants_seen) > 1:
            self.mixed_batches += 1
        if batch:
            _m_tenants_per_batch.observe(float(len(tenants_seen)))
        self._rr.append(self._rr.pop(0))
        _m_queue_depth.set(float(len(self._pending)))
        return batch

    # -- stats ------------------------------------------------------------
    def reset_stats(self) -> None:
        super().reset_stats()
        with self._cond:
            self.mixed_batches = 0
            self.tenant_claims = {}

    def stats(self) -> dict:
        out = super().stats()
        with self._cond:
            out["shared"] = True
            out["tenantsRegistered"] = len(self._reg_counts)
            out["mixedBatches"] = self.mixed_batches
            out["tenantClaims"] = {
                ("/".join(str(p) for p in k) if isinstance(k, tuple)
                 else str(k)): v
                for k, v in self.tenant_claims.items()
            }
        return out


class SharedBatcherView:
    """One tenant's handle on a :class:`SharedBatcher`.

    Exposes the surface the serving edges use on a private
    ``MicroBatcher`` (``submit`` / ``submit_nowait`` /
    ``check_admission`` / ``estimate_wait_s`` / ``stats`` / ``batch_fn``
    / ``close``), stamping every entry with the tenant key and the
    tenant's own ``batch_fn``.  ``close()`` retires only this tenant's
    scheduling state; the shared core and its dispatcher live until the
    server stops."""

    __slots__ = ("core", "tenant", "batch_fn", "_closed")

    def __init__(self, core: SharedBatcher, tenant, batch_fn: Callable,
                 weight: float = 1.0,
                 weight_fn: Optional[Callable] = None):
        self.core = core
        self.tenant = tenant
        self.batch_fn = batch_fn
        self._closed = False
        core.register_tenant(tenant, weight=weight, weight_fn=weight_fn)

    @property
    def max_batch(self) -> int:
        return self.core.max_batch

    @property
    def pad_batches(self) -> bool:
        return self.core.pad_batches

    def estimate_wait_s(self) -> float:
        return self.core.estimate_wait_s()

    def check_admission(self, deadline: Optional[Deadline]) -> None:
        self.core.check_admission(deadline)

    def stats(self) -> dict:
        out = self.core.stats()
        out["tenant"] = str(self.tenant)
        return out

    def reset_stats(self) -> None:
        self.core.reset_stats()

    def submit(self, item: Any, deadline: Optional[Deadline] = None) -> Any:
        if self._closed:
            raise RuntimeError("batcher is closed")
        return self.core.submit(item, deadline=deadline,
                                tenant=self.tenant, fn=self.batch_fn)

    def submit_nowait(self, item: Any, on_done: Callable,
                      deadline: Optional[Deadline] = None,
                      timeline=None) -> None:
        # a closed view raises what a closed MicroBatcher raises: the
        # event-loop edge's reload retry keys on it
        if self._closed:
            raise RuntimeError("batcher is closed")
        self.core.submit_nowait(item, on_done, deadline=deadline,
                                timeline=timeline, tenant=self.tenant,
                                fn=self.batch_fn)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.core.retire_tenant(self.tenant)
