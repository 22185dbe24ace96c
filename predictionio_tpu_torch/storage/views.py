"""Deprecated batch-view API kept for source compatibility.

Copy of ``predictionio_tpu/storage/views.py`` for the port.  Re-expression of the reference's 0.8-era view layer
(`data/src/main/scala/io/prediction/data/view/LBatchView.scala`,
`PBatchView.scala`, `DataView.scala`) which newer engines replaced with the
store facades (`store/PEventStore.scala`).  Engines written against the old
`LBatchView(appId).events.filter(...).aggregateByEntityOrdered(...)` shape
can migrate mechanically; new code should use
:mod:`predictionio_tpu_torch.storage.store` instead.

One class serves both the reference's L (local list) and P (Spark RDD)
variants: the embedded store always yields host events, and the batch
("P") aggregation path is the same columnar fold used by the facades.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Iterable, Optional, TypeVar

from .aggregate import aggregate_properties
from .event import DataMap, Event, parse_time
from .levents import EventStore

__all__ = ["EventSeq", "BatchView", "LBatchView", "PBatchView"]

T = TypeVar("T")


def _predicate(
    start_time: Optional[Any] = None,
    until_time: Optional[Any] = None,
    entity_type: Optional[str] = None,
    event_name: Optional[str] = None,
) -> Callable[[Event], bool]:
    """Compose the ViewPredicates.* filters (`LBatchView.scala:29-65`)."""
    st = parse_time(start_time) if isinstance(start_time, str) else start_time
    ut = parse_time(until_time) if isinstance(until_time, str) else until_time

    def pred(e: Event) -> bool:
        t = e.event_time
        if st is not None and t < st:
            return False
        if ut is not None and t >= ut:
            return False
        if entity_type is not None and e.entity_type != entity_type:
            return False
        if event_name is not None and e.event != event_name:
            return False
        return True

    return pred


class EventSeq:
    """List-like event sequence with the old filter/aggregate combinators
    (`LBatchView.scala:94-131`)."""

    def __init__(self, events: Iterable[Event]):
        self.events: list[Event] = list(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def filter(
        self,
        predicate: Optional[Callable[[Event], bool]] = None,
        *,
        start_time: Optional[Any] = None,
        until_time: Optional[Any] = None,
        entity_type: Optional[str] = None,
        event_name: Optional[str] = None,
    ) -> "EventSeq":
        pred = predicate or _predicate(
            start_time, until_time, entity_type, event_name
        )
        return EventSeq(e for e in self.events if pred(e))

    def aggregate_by_entity_ordered(
        self, init: T, op: Callable[[T, Event], T]
    ) -> dict[str, T]:
        """Per-entity time-ordered fold (`LBatchView.scala:121-131`)."""
        groups: dict[str, list[Event]] = {}
        for e in self.events:
            groups.setdefault(e.entity_id, []).append(e)
        out: dict[str, T] = {}
        for eid, evs in groups.items():
            acc = init
            for e in sorted(evs, key=lambda x: x.event_time):
                acc = op(acc, e)
            out[eid] = acc
        return out

    def group_by_entity_ordered(
        self, proc: Callable[[Event], T]
    ) -> dict[str, list[T]]:
        """Per-entity time-ordered map (`LBatchView.scala:189-200`)."""
        groups: dict[str, list[Event]] = {}
        for e in self.events:
            groups.setdefault(e.entity_id, []).append(e)
        return {
            eid: [proc(e) for e in sorted(evs, key=lambda x: x.event_time)]
            for eid, evs in groups.items()
        }


class BatchView:
    """`LBatchView`/`PBatchView` replacement over the embedded store."""

    def __init__(
        self,
        store: EventStore,
        app_id: int,
        channel_id: int = 0,
        start_time: Optional[Any] = None,
        until_time: Optional[Any] = None,
    ):
        self._store = store
        self.app_id = app_id
        self.channel_id = channel_id
        self.start_time = (
            parse_time(start_time) if isinstance(start_time, str) else start_time
        )
        self.until_time = (
            parse_time(until_time) if isinstance(until_time, str) else until_time
        )
        self._events: Optional[EventSeq] = None

    @property
    def events(self) -> EventSeq:
        """All events in the window, memoized (`LBatchView.scala:142-154`)."""
        if self._events is None:
            self._events = EventSeq(
                self._store.find(
                    self.app_id,
                    self.channel_id,
                    start_time=self.start_time,
                    until_time=self.until_time,
                )
            )
        return self._events

    def aggregate_properties(
        self, entity_type: Optional[str] = None
    ) -> dict[str, DataMap]:
        """$set/$unset/$delete snapshot per entity
        (`LBatchView.scala:156-172`, `PBatchView.scala:188-206`)."""
        evs = self.events
        if entity_type is not None:
            evs = evs.filter(entity_type=entity_type)
        return {
            eid: DataMap(pm.fields)
            for eid, pm in aggregate_properties(evs).items()
        }

    def aggregate_by_entity_ordered(
        self,
        init: T,
        op: Callable[[T, Event], T],
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> dict[str, T]:
        evs = self.events if predicate is None else self.events.filter(predicate)
        return evs.aggregate_by_entity_ordered(init, op)


def _deprecated(old: str) -> None:
    warnings.warn(
        f"{old} is the 0.8-era view API; use "
        "predictionio_tpu_torch.storage.store facades instead",
        DeprecationWarning,
        stacklevel=3,
    )


class LBatchView(BatchView):
    def __init__(self, *a, **kw):
        _deprecated("LBatchView")
        super().__init__(*a, **kw)


class PBatchView(BatchView):
    def __init__(self, *a, **kw):
        _deprecated("PBatchView")
        super().__init__(*a, **kw)
