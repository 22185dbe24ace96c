"""Event-server stats: lifetime + hourly counters
(reference `data/api/StatsActor.scala:29-74`, `data/api/Stats.scala:27-79`).

Port of ``predictionio_tpu/server/stats.py``, mirrored into the
process-wide ``obs`` counters as the reference does.  Counters by
(appId, status-code) and (appId, event, entityType, targetEntityType);
the actor model collapses to a lock-guarded aggregate fed
fire-and-forget from the request handlers.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

from ..obs import EVENTS_TOTAL, RESILIENCE_TOTAL

__all__ = ["Stats", "StatsCollector", "KindedEvent",
           "merge_stats_payloads"]


def _merge_stats_json(parts: list[dict]) -> dict:
    counts: Counter = Counter()
    kinds: Counter = Counter()
    start = None
    for p in parts:
        st = p.get("startTime")
        if st is not None:
            start = st if start is None else min(start, st)
        for row in p.get("statusCount", ()):
            counts[(row["appId"], row["status"])] += row["count"]
        for row in p.get("eventCount", ()):
            key = (row["appId"], row["event"], row["entityType"],
                   row.get("targetEntityType"))
            kinds[key] += row["count"]
    return {
        "startTime": start if start is not None else time.time(),
        "statusCount": [
            {"appId": a, "status": s, "count": c}
            for (a, s), c in sorted(counts.items())
        ],
        "eventCount": [
            {"appId": a, "event": e, "entityType": et,
             "targetEntityType": tet, "count": c}
            for (a, e, et, tet), c in sorted(
                kinds.items(), key=lambda kv: (kv[0][0], kv[0][1])
            )
        ],
    }


def merge_stats_payloads(payloads: list[dict]) -> dict:
    """Federate per-worker ``/stats.json`` payloads into one fleet
    view: counters sum by key, ``startTime`` is
    the fleet's earliest boot.  Same monotone-through-death discipline
    as the ``/metrics`` federation — feed a dead worker's LAST GOOD
    payload and the merged counts never step backward; they resume
    climbing when its replacement reports in (counts restart at zero
    per process, so the merged total dips only if the caller DROPS the
    dead worker's snapshot instead of keeping it standing)."""
    out: dict = {}
    for window in ("lifetime", "currentHour"):
        out[window] = _merge_stats_json(
            [p.get(window) or {} for p in payloads]
        )
    prevs = [p["previousHour"] for p in payloads
             if p.get("previousHour")]
    out["previousHour"] = _merge_stats_json(prevs) if prevs else None
    res: Counter = Counter()
    for p in payloads:
        for k, v in (p.get("resilience") or {}).items():
            res[k] += v
    out["resilience"] = dict(sorted(res.items()))
    return out


@dataclass(frozen=True)
class KindedEvent:
    app_id: int
    event: str
    entity_type: str
    target_entity_type: Optional[str]


@dataclass
class Stats:
    start_time: float = field(default_factory=time.time)
    status_count: Counter = field(default_factory=Counter)  # (appId, status)
    event_count: Counter = field(default_factory=Counter)   # KindedEvent

    def update(self, app_id: int, status: int, kinded: Optional[KindedEvent]):
        self.status_count[(app_id, status)] += 1
        if kinded is not None:
            self.event_count[kinded] += 1

    def to_json(self, app_id: Optional[int] = None) -> dict:
        def keep_app(a):
            return app_id is None or a == app_id

        return {
            "startTime": self.start_time,
            "statusCount": [
                {"appId": a, "status": s, "count": c}
                for (a, s), c in sorted(self.status_count.items())
                if keep_app(a)
            ],
            "eventCount": [
                {
                    "appId": k.app_id,
                    "event": k.event,
                    "entityType": k.entity_type,
                    "targetEntityType": k.target_entity_type,
                    "count": c,
                }
                for k, c in sorted(
                    self.event_count.items(),
                    key=lambda kv: (kv[0].app_id, kv[0].event),
                )
                if keep_app(k.app_id)
            ],
        }


class StatsCollector:
    """Long-lived + current-hour + previous-hour windows
    (reference `StatsActor`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lifetime = Stats()
        self.current = Stats()
        self.previous: Optional[Stats] = None
        self._hour = self._hour_now()
        # resilience counters (storage.write.retry, storage.read.retry,
        # ...): lifetime-scoped, fed by the retry policies' on_retry
        # hooks so operators can see recovered-from trouble, not just
        # terminal failures
        self.resilience: Counter = Counter()

    @staticmethod
    def _hour_now() -> int:
        return int(time.time() // 3600)

    def _roll(self) -> None:
        h = self._hour_now()
        if h != self._hour:
            self.previous = self.current
            self.current = Stats()
            self._hour = h

    def bookkeeping(self, app_id: int, status: int, event=None) -> None:
        kinded = (
            KindedEvent(
                app_id=app_id,
                event=event.event,
                entity_type=event.entity_type,
                target_entity_type=event.target_entity_type,
            )
            if event is not None
            else None
        )
        with self._lock:
            self._roll()
            self.lifetime.update(app_id, status, kinded)
            self.current.update(app_id, status, kinded)
        # mirror into the process-wide registry: status alone keeps the
        # label cardinality bounded; per-app counts stay in /stats.json
        EVENTS_TOTAL.labels(status=str(status)).inc()

    def note(self, counter: str, n: int = 1) -> None:
        """Bump a named resilience counter (e.g. ``storage.write.retry``)."""
        with self._lock:
            self.resilience[counter] += n
        RESILIENCE_TOTAL.labels(kind=counter).inc(n)

    def to_json(self, app_id: Optional[int] = None) -> dict:
        with self._lock:
            self._roll()
            return {
                "lifetime": self.lifetime.to_json(app_id),
                "currentHour": self.current.to_json(app_id),
                "previousHour": (
                    self.previous.to_json(app_id) if self.previous else None
                ),
                "resilience": dict(sorted(self.resilience.items())),
            }
