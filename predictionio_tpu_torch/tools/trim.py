"""Trim old events from an app's event store.

Port of ``predictionio_tpu/tools/trim.py``, the capability analogue of
the reference's `examples/experimental/scala-parallel-trim-app`: a
find-and-delete over the embedded store behind ``app trim``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

from ..storage.levents import EventStore

__all__ = ["trim_events"]


def trim_events(
    store: EventStore,
    app_id: int,
    channel_id: int = 0,
    before: Optional[_dt.datetime] = None,
    event_names: Optional[Sequence[str]] = None,
    keep_special: bool = True,
    batch: int = 5000,
) -> int:
    """Delete events older than ``before`` (and/or matching
    ``event_names``); returns the number deleted.

    ``keep_special`` preserves ``$set/$unset/$delete`` property events so
    entity snapshots survive the trim.
    """
    if before is None and not event_names:
        raise ValueError(
            "trim requires a time window (before=...) and/or event names; "
            "use data-delete to drop everything"
        )
    # collect ids first, then delete: interleaving deletes with a live
    # find() cursor is undefined on cursor-backed stores
    to_delete = [
        e.event_id
        for e in store.find(
            app_id=app_id, channel_id=channel_id, until_time=before,
            event_names=list(event_names) if event_names else None,
        )
        if e.event_id and not (keep_special and e.event.startswith("$"))
    ]
    n = 0
    for s in range(0, len(to_delete), batch):
        n += store.delete_batch(to_delete[s : s + batch], app_id, channel_id)
    return n
