"""Engine-facing store facades (the reference's L4 layer).

Copy of ``predictionio_tpu/storage/store.py`` for the port.  Parity with `data/src/main/scala/io/prediction/data/store/`:

* :func:`app_name_to_id` — `store/Common.scala` ``appNameToId``: resolves an
  app **name** (+ optional channel name) to ``(app_id, channel_id)`` via the
  metadata store, raising on unknown names.
* :class:`PEventStore` — `store/PEventStore.scala:54-114`: the batch read API
  used from DataSources.  ``find`` returns a columnar
  :class:`~predictionio_tpu_torch.storage.columnar.EventFrame` (the
  columnar replacement for ``RDD[Event]``) and ``aggregate_properties`` returns folded
  entity property snapshots.
* :class:`LEventStore` — `store/LEventStore.scala:59-88`: the low-latency
  single-entity read API used from ``Algorithm.predict`` at serving time
  (e-commerce template's seen/unavailable-item filtering), with an explicit
  ``timeout``-free synchronous contract and latest-first ordering.

Both facades address data by **app name + channel name**, never raw ids —
mirroring the reference's deliberate API asymmetry with the DAO layer.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterator, Optional, Sequence

from .columnar import EventFrame
from .event import Event, PropertyMap
from .registry import Storage, get_storage

__all__ = ["app_name_to_id", "PEventStore", "LEventStore"]


def app_name_to_id(
    app_name: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> tuple[int, int]:
    """Resolve (app name, channel name) -> (app_id, channel_id).

    Mirrors `store/Common.scala` ``appNameToId``: unknown app or channel is
    an error; ``channel_name=None`` means the default channel (id 0).
    """
    storage = storage or get_storage()
    md = storage.get_metadata()
    app = md.app_get_by_name(app_name)
    if app is None:
        raise ValueError(f"App with name '{app_name}' does not exist")
    if channel_name is None:
        return app.id, 0
    for ch in md.channel_get_by_app(app.id):
        if ch.name == channel_name:
            return app.id, ch.id
    raise ValueError(
        f"Channel '{channel_name}' does not exist in app '{app_name}'"
    )


class PEventStore:
    """Batch (training-time) read facade addressed by app name."""

    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage or get_storage()

    def find(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type=None,
        target_entity_id=None,
    ) -> EventFrame:
        """Columnar batch read (`PEventStore.scala:54-80`)."""
        app_id, channel_id = app_name_to_id(
            app_name, channel_name, self._storage
        )
        es = self._storage.get_event_store()
        kwargs = dict(
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
        # part of the EventStore contract: the base class supplies a
        # generic implementation, sqlite overrides with a native bulk read
        return es.find_columnar(**kwargs)

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """Entity property snapshots (`PEventStore.scala:94-114`)."""
        app_id, channel_id = app_name_to_id(
            app_name, channel_name, self._storage
        )
        es = self._storage.get_event_store()
        return es.aggregate_properties_of(
            app_id=app_id,
            entity_type=entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )


class LEventStore:
    """Low-latency (serving-time) read facade addressed by app name."""

    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage or get_storage()

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type=None,
        target_entity_id=None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """Entity-scoped scan, latest-first by default
        (`LEventStore.scala:59-88`)."""
        app_id, channel_id = app_name_to_id(
            app_name, channel_name, self._storage
        )
        es = self._storage.get_event_store()
        return es.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )
