"""Entity property aggregation: folding ``$set`` / ``$unset`` / ``$delete``
event streams into per-entity property snapshots.

Copy of ``predictionio_tpu/storage/aggregate.py`` for the port.
Behavioral parity with reference `LEventAggregator.scala:24-115` (local
iterator fold) and `PEventAggregator.scala:35-209`: one host-side
implementation over JSON property bags.

Fold semantics (per entity, events sorted by event_time ascending):
  * ``$set``    — merge properties over current (later wins); creates the
                  entity if absent.
  * ``$unset``  — remove the listed property keys (no-op if entity absent).
  * ``$delete`` — drop the entity entirely (subsequent ``$set`` recreates).
  * any other event — ignored.
Entities whose final state is "deleted"/never-set are excluded.  first/last
updated times cover every special event touching the entity (including the
trailing ``$delete``-then-``$set`` case), matching `propAggregator`.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Iterable, Optional

from .event import DataMap, Event, PropertyMap

__all__ = ["aggregate_properties", "aggregate_properties_single"]


@dataclass
class _Prop:
    dm: Optional[DataMap] = None
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None


def _fold(p: _Prop, e: Event) -> _Prop:
    if e.event == "$set":
        p.dm = e.properties if p.dm is None else p.dm.merged(e.properties)
    elif e.event == "$unset":
        p.dm = None if p.dm is None else p.dm.without(e.properties.keyset())
    elif e.event == "$delete":
        p.dm = None
    else:
        return p  # non-special events do not touch properties or times
    p.first_updated = (
        e.event_time
        if p.first_updated is None
        else min(p.first_updated, e.event_time)
    )
    p.last_updated = (
        e.event_time if p.last_updated is None else max(p.last_updated, e.event_time)
    )
    return p


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Group by entity_id, sort by event_time, fold — returns only entities
    with defined final properties (reference `LEventAggregator.scala:24-64`)."""
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        evs.sort(key=lambda e: e.event_time)
        p = _Prop()
        for e in evs:
            p = _fold(p, e)
        if p.dm is not None:
            assert p.first_updated is not None and p.last_updated is not None
            out[entity_id] = PropertyMap(
                p.dm.fields, first_updated=p.first_updated, last_updated=p.last_updated
            )
    return out


def aggregate_properties_single(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Fold a single entity's event stream
    (reference `LEventAggregator.scala:67-89`)."""
    evs = sorted(events, key=lambda e: e.event_time)
    p = _Prop()
    for e in evs:
        p = _fold(p, e)
    if p.dm is None:
        return None
    assert p.first_updated is not None and p.last_updated is not None
    return PropertyMap(
        p.dm.fields, first_updated=p.first_updated, last_updated=p.last_updated
    )
