"""Slow-query flight recorder: a bounded worst-N ring of span trees.

The latency histogram says *that* the p99 moved; the flight recorder
says *why*, for the concrete requests that moved it.  Every finished
request is **offered** with its trace id and duration; the recorder
keeps the N slowest offers seen so far, and for each admitted request
captures its full span tree (every span the tracer ring holds for that
trace id — ``serve.query``, ``als.*`` probes, ``events.write`` on the
feedback hop, ...) at admission time, before the bounded ring can
evict them.

Hot-path discipline: the common case (request not among the worst N) is
one lock acquisition and one float compare.  The span-tree capture — an
O(ring) scan — happens only for admitted requests, which are by
definition the slow ones; amortized cost on a healthy p50 is nil.

Admission is exact under concurrency: the cheap pre-check may race, but
every candidate that passes it re-enters the lock, is pushed, and the
heap is trimmed back to capacity — so the final contents are always
exactly the N largest durations ever offered (a request rejected by a
stale pre-check had ``duration <= min(heap)`` at that moment, and the
heap minimum only grows).

The exemplar trace ids the latency histogram carries (registry.py) are
the cross-link: ``/metrics`` names a trace id, the flight record holds
its span tree, the JSONL journal holds the cross-process copy.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from typing import Optional

__all__ = ["FlightRecorder", "get_flight_recorder"]


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("PIO_TPU_XRAY_FLIGHT_N", 16)))
    except ValueError:
        return 16


class FlightRecorder:
    """Keep the worst-``capacity`` offered requests with span trees."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity if capacity else _env_capacity()
        # min-heap of (duration_s, seq, record); seq breaks duration
        # ties so dict records never get compared
        self._heap: list = []
        self._seq = 0
        self._offers = 0
        self._admissions = 0

    # -- configuration -----------------------------------------------------
    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        with self._lock:
            self._capacity = capacity
            while len(self._heap) > capacity:
                heapq.heappop(self._heap)

    # -- recording ---------------------------------------------------------
    def offer(self, trace_id: Optional[str], duration_s: float,
              name: str = "serve.query",
              attrs: Optional[dict] = None, tracer=None) -> bool:
        """Offer one finished request; returns True when admitted.

        ``trace_id=None`` requests are counted but never admitted —
        without an id there is no span tree to key."""
        with self._lock:
            self._offers += 1
            if trace_id is None:
                return False
            if (
                len(self._heap) >= self._capacity
                and duration_s <= self._heap[0][0]
            ):
                return False
        # capture OUTSIDE the lock: the tracer has its own lock, and
        # holding ours across it would couple the two hot paths
        if tracer is None:
            from . import get_tracer

            tracer = get_tracer()
        spans = [s.to_json() for s in tracer.spans(trace_id=trace_id)]
        # pio-scope join: the dominant CPU stacks sampled during this
        # request's wall window — "what was the process doing while
        # this request was slow".  Offers arrive at request end, so
        # the window is [now - duration, now]; the profiler widens it
        # to covering 1 s ring buckets.  Admitted requests only — an
        # O(ring) read has no place on the healthy p50 path.
        now = time.time()
        stacks = None
        try:
            from . import scope as _scope

            if _scope.profiler_running():
                stacks = _scope.get_profiler().dominant_stacks(
                    now - duration_s, now
                )
        except Exception:
            stacks = None  # a profiler hiccup must not drop the record
        record = {
            "traceId": trace_id,
            "name": name,
            "durationSec": duration_s,
            "at": now,
            "spanCount": len(spans),
            "spans": spans,
            **({"dominantStacks": stacks} if stacks else {}),
            **({"attrs": attrs} if attrs else {}),
        }
        with self._lock:
            if (
                len(self._heap) >= self._capacity
                and duration_s <= self._heap[0][0]
            ):
                return False  # a concurrent slower request won the slot
            self._seq += 1
            heapq.heappush(self._heap, (duration_s, self._seq, record))
            while len(self._heap) > self._capacity:
                heapq.heappop(self._heap)
            self._admissions += 1
        return True

    def annotate(self, trace_id: str, extra: dict) -> bool:
        """Merge ``extra`` into an admitted record's attrs after the
        fact (pio-lens: the router caches a replica's lazily-fetched
        ``segmentsMs`` into its own worst-N entry so the second
        ``/debug/fleet`` read costs no replica round trip).  Returns
        False when the record was never admitted or already evicted."""
        with self._lock:
            for _, _, r in self._heap:
                if r["traceId"] == trace_id:
                    r.setdefault("attrs", {}).update(extra)
                    return True
        return False

    # -- reading -----------------------------------------------------------
    def records(self) -> list:
        """Full flight records, slowest first."""
        with self._lock:
            snap = list(self._heap)
        return [r for _, _, r in sorted(snap, reverse=True)]

    def record_for(self, trace_id: str) -> Optional[dict]:
        for r in self.records():
            if r["traceId"] == trace_id:
                return r
        return None

    def summary(self, spans: bool = False) -> dict:
        """Status-JSON-sized view; ``spans=True`` inlines the trees
        (the /debug/xray payload wants them, /status does not)."""
        with self._lock:
            snap = list(self._heap)
            offers = self._offers
            admissions = self._admissions
            capacity = self._capacity
        worst = []
        for _, _, r in sorted(snap, reverse=True):
            item = {k: r[k] for k in
                    ("traceId", "name", "durationSec", "at", "spanCount")}
            if "dominantStacks" in r:
                # the pio-scope join travels with the summary: a
                # worst-N line names its hot stacks without a second
                # round trip for the full record
                item["dominantStacks"] = r["dominantStacks"]
            if "attrs" in r:
                # capture-time context (pulse segment decomposition,
                # pio-live modelFreshnessSec/foldinSeq): a worst-N line
                # on /status explains itself without the span tree
                item["attrs"] = r["attrs"]
            if spans:
                item["spans"] = r["spans"]
            worst.append(item)
        return {
            "capacity": capacity,
            "offers": offers,
            "admissions": admissions,
            "worst": worst,
        }

    def clear(self) -> None:
        with self._lock:
            self._heap = []
            self._offers = 0
            self._admissions = 0


_flight = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _flight
