"""Event store contract + hermetic in-memory backend.

Copy of ``predictionio_tpu/storage/levents.py`` for the port: the
synchronous re-expression of the reference `LEvents` DAO
(`data/.../storage/LEvents.scala:31-451`).  Filter semantics of ``find``
match the reference exactly, including the tri-state target-entity
filters (``None`` = unrestricted, ``NO_TARGET`` = event must have no
target, a string = must equal).  ``extract_entity_map`` gives the
reference's typed ``EntityMap`` of each entity's aggregated properties.
"""

from __future__ import annotations

import abc
import contextlib
import datetime as _dt
import itertools
import threading
from typing import Iterable, Iterator, Optional, Sequence, Union

from .aggregate import aggregate_properties, aggregate_properties_single
from .event import Event, PropertyMap, new_event_id, validate_event

__all__ = ["NO_TARGET", "EventStore", "MemoryEventStore",
           "ShardUnavailableError"]


class ShardUnavailableError(Exception):
    """One shard of the event store cannot serve right now (a broken
    ingest WAL; in the reference also a dead owner worker or an injected
    ``store.shard_down``).

    Deliberately not a ``sqlite3.OperationalError``: the condition is
    sticky until the owner recovers, so the ingest edge answers a
    structured 503 + Retry-After at once instead of spending its
    transient-error retry budget.  ``shard`` names the component that is
    down, never the whole store."""

    def __init__(self, shard: int, reason: str = "shard unavailable"):
        super().__init__(f"shard {shard} unavailable: {reason}")
        self.shard = int(shard)
        self.reason = reason


class _NoTarget:
    """Sentinel: filter for events with no target entity
    (reference ``Some(None)`` in `LEvents.scala:126-138`)."""

    _instance: "_NoTarget | None" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NO_TARGET"


NO_TARGET = _NoTarget()

TargetFilter = Union[None, _NoTarget, str]


class EventStore(abc.ABC):
    """Single-record + scan event DAO (the `LEvents` contract)."""

    # -- lifecycle --------------------------------------------------------
    @abc.abstractmethod
    def init_channel(self, app_id: int, channel_id: int = 0) -> bool:
        """Initialize storage for (app, channel); idempotent."""

    @abc.abstractmethod
    def remove_channel(self, app_id: int, channel_id: int = 0) -> bool:
        """Drop all events of (app, channel)."""

    def close(self) -> None:  # noqa: B027 — optional hook
        pass

    def compact(self) -> None:  # noqa: B027 — optional hook
        """Reclaim storage space freed by deletes (`app trim`).

        The reference's trim flow rewrote the event table (a Spark job
        writing a fresh copy minus the window —
        `examples/experimental/scala-parallel-trim-app`), which
        implicitly compacted; embedded stores must offer the same
        reclamation explicitly (sqlite: VACUUM).  Default no-op for
        stores without free-space bookkeeping."""

    # -- writes -----------------------------------------------------------
    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int = 0,
               validate: bool = True) -> str:
        """Persist (validating first unless ``validate=False`` — for
        events that already passed validation, e.g. from
        ``Event.from_json``); returns the assigned event id."""

    def insert_batch(
        self,
        events: Iterable[Event],
        app_id: int,
        channel_id: int = 0,
        validate: bool = True,
    ) -> list[str]:
        """``validate=False`` skips per-event re-validation for events
        that already passed it (e.g. built by ``Event.from_json``) — the
        bulk-import path validated twice otherwise."""
        return [
            self.insert(e, app_id, channel_id, validate=validate)
            for e in events
        ]

    @contextlib.contextmanager
    def bulk(self):
        """Bulk-write scope: transactional backends may defer their
        commit to the end of the scope (one fsync per import instead of
        one per batch).  Base implementation is a no-op."""
        yield self

    # -- point reads ------------------------------------------------------
    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int = 0
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: int = 0) -> bool: ...

    def delete_batch(
        self, event_ids: Iterable[str], app_id: int, channel_id: int = 0
    ) -> int:
        """Bulk delete; returns the number actually removed.  Backends
        override to avoid per-row commits."""
        return sum(
            bool(self.delete(eid, app_id, channel_id)) for eid in event_ids
        )

    # -- scans ------------------------------------------------------------
    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int = 0,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: TargetFilter = None,
        target_entity_id: TargetFilter = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Scan with the reference's filter set (`LEvents.scala:103-138`).

        ``limit=None`` or ``-1`` means all; ``reversed`` returns latest
        events first.  Events are ordered by event_time.
        """

    # -- columnar batch read (PEvents analogue) ---------------------------
    def find_columnar(
        self,
        app_id: int,
        channel_id: int = 0,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: TargetFilter = None,
        target_entity_id: TargetFilter = None,
        float_property: Optional[str] = None,
        float_default: float = float("nan"),
        minimal: bool = False,
        cache: Optional[bool] = None,
    ):
        """Bulk scan into column arrays (the `PEvents` analogue,
        reference `data/.../storage/PEvents.scala:30-138`).

        ``minimal=True`` is an optimization HINT: the caller promises to
        touch only ``entity_id``/``target_entity_id``/``event_time_ms``
        (+ ``value``), letting backends skip the other columns.  This
        generic implementation ignores it (a full frame satisfies the
        contract).  ``cache`` likewise: backends with a snapshot cache
        (sqlite) honor it; others ignore it.

        Generic implementation built on :meth:`find` +
        :func:`~predictionio_tpu_torch.storage.columnar.events_to_frame`, so
        EVERY backend satisfies the columnar contract; backends with a
        native bulk path override it
        (`sqlite_events.SQLiteEventStore.find_columnar` reads straight
        from the cursor).  With ``float_property`` the named property is
        extracted per event into a float64 ``value`` column (missing ->
        ``float_default``) — the training-data hot path.
        """
        from dataclasses import replace

        from .columnar import events_to_frame

        frame = events_to_frame(
            self.find(
                app_id=app_id,
                channel_id=channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
            )
        )
        if float_property is not None:
            frame = replace(
                frame,
                value=frame.property_column(float_property, float_default),
                properties=None,
            )
        return frame

    # -- aggregation (built on find, like the reference) ------------------
    def aggregate_properties_of(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int = 0,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        result = aggregate_properties(events)
        if required:
            result = {
                k: v
                for k, v in result.items()
                if all(r in v for r in required)
            }
        return result

    def extract_entity_map(
        self,
        extract,
        app_id: int,
        entity_type: str,
        channel_id: int = 0,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ):
        """Typed entity extraction: aggregate ``$set``/``$unset`` state per
        entity, keep entities holding every ``required`` property, and map
        each property bag through ``extract`` into an
        :class:`~predictionio_tpu_torch.storage.bimap.EntityMap` (reference
        ``PEvents.extractEntityMap``, `data/.../PEvents.scala:109-115`)."""
        from .bimap import EntityMap

        props = self.aggregate_properties_of(
            app_id=app_id,
            entity_type=entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )
        return EntityMap({k: extract(v) for k, v in props.items()})

    def aggregate_properties_single_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int = 0,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Optional[PropertyMap]:
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=["$set", "$unset", "$delete"],
        )
        return aggregate_properties_single(events)


def _match(
    e: Event,
    start_time,
    until_time,
    entity_type,
    entity_id,
    event_names,
    target_entity_type,
    target_entity_id,
) -> bool:
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not None:
        if target_entity_type is NO_TARGET:
            if e.target_entity_type is not None:
                return False
        elif e.target_entity_type != target_entity_type:
            return False
    if target_entity_id is not None:
        if target_entity_id is NO_TARGET:
            if e.target_entity_id is not None:
                return False
        elif e.target_entity_id != target_entity_id:
            return False
    return True


class MemoryEventStore(EventStore):
    """Hermetic in-memory backend (list per (app, channel), lock-guarded)."""

    def __init__(self, config=None):
        self._lock = threading.RLock()
        self._tables: dict[tuple[int, int], dict[str, Event]] = {}

    def _table(self, app_id: int, channel_id: int) -> dict[str, Event]:
        key = (app_id, channel_id)
        with self._lock:
            if key not in self._tables:
                self._tables[key] = {}
            return self._tables[key]

    def init_channel(self, app_id: int, channel_id: int = 0) -> bool:
        self._table(app_id, channel_id)
        return True

    def remove_channel(self, app_id: int, channel_id: int = 0) -> bool:
        with self._lock:
            return self._tables.pop((app_id, channel_id), None) is not None

    def insert(self, event: Event, app_id: int, channel_id: int = 0,
               validate: bool = True) -> str:
        if validate:
            validate_event(event)
        eid = event.event_id or new_event_id()
        with self._lock:
            self._table(app_id, channel_id)[eid] = event.with_id(eid)
        return eid

    def get(self, event_id: str, app_id: int, channel_id: int = 0) -> Optional[Event]:
        with self._lock:
            return self._table(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: int = 0) -> bool:
        with self._lock:
            return self._table(app_id, channel_id).pop(event_id, None) is not None

    def find(
        self,
        app_id: int,
        channel_id: int = 0,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type: TargetFilter = None,
        target_entity_id: TargetFilter = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            evs = list(self._table(app_id, channel_id).values())
        evs.sort(key=lambda e: (e.event_time, e.event_id or ""), reverse=reversed)
        it = (
            e
            for e in evs
            if _match(
                e,
                start_time,
                until_time,
                entity_type,
                entity_id,
                event_names,
                target_entity_type,
                target_entity_id,
            )
        )
        if limit is not None and limit >= 0:
            it = itertools.islice(it, limit)
        return it
