"""Columnar event batches and rating triples — the `PEvents` analogue.

Copy of ``predictionio_tpu/storage/columnar.py`` for the port.  The
reference's batch path hands engines `RDD[Event]`
(`data/.../storage/PEvents.scala:30-138`); here the batch currency is
struct-of-arrays (:class:`EventFrame`), which data sources turn into
contiguous-index COO arrays (:class:`Ratings`, through
:class:`~predictionio_tpu_torch.storage.bimap.StringIndex`) without
per-event Python objects on the hot path.  The encoding is the
reference's, so the same events give the same ``Ratings`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from .bimap import StringIndex
from .event import Event, time_millis

__all__ = ["EventFrame", "dedup_coo", "events_to_frame", "Ratings"]


def dedup_coo(u, it, v, t, n_items: int, dedup: str):
    """Shared (user, item) pair dedup over an encoded COO — ONE
    definition used by ``EventFrame.to_ratings`` and the native
    fused-scan path (`sqlite_events.find_ratings`), so the two read
    paths cannot drift.

    ``dedup``: 'last' keeps the latest EVENT TIME per pair, with
    EQUAL-time duplicates tie-broken by the larger value — a pure
    function of the row multiset, so scan order (python cursor vs
    native rowid walk vs shard interleave) can never pick different
    survivors.  'sum' accumulates, 'none' keeps all.  Returns
    ``(u, it, v)``.
    """
    if dedup == "none" or not len(u):
        return u, it, v
    pair = u.astype(np.int64) * n_items + it
    if dedup == "last":
        order = np.lexsort((v, t, pair))
        pair_s = pair[order]
        keep = np.r_[pair_s[1:] != pair_s[:-1], True]
        sel = order[keep]
        return u[sel], it[sel], v[sel]
    if dedup == "sum":
        uniq, inv = np.unique(pair, return_inverse=True)
        v = np.bincount(inv, weights=v, minlength=len(uniq))
        return (
            (uniq // n_items).astype(np.int32),
            (uniq % n_items).astype(np.int32),
            v,
        )
    raise ValueError(f"unknown dedup mode: {dedup}")


@dataclass
class EventFrame:
    """Struct-of-arrays view of an event scan (all len-n, object dtype for
    strings; ``value`` is the pre-extracted float property column when the
    scan requested one, ``properties`` the parsed dicts otherwise).

    A ``minimal`` scan (`find_columnar(minimal=True)`) fills only
    ``entity_id``/``target_entity_id``/``event_time_ms`` (+ ``value``);
    the other columns are ``None`` — enough for ``to_ratings`` and
    ``select``, at ~half the scan cost of the full frame."""

    event: Optional[np.ndarray]
    entity_type: Optional[np.ndarray]
    entity_id: np.ndarray
    target_entity_type: Optional[np.ndarray]
    target_entity_id: np.ndarray
    event_time_ms: np.ndarray
    properties: Optional[np.ndarray] = None
    value: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.entity_id)

    def select(self, mask: np.ndarray) -> "EventFrame":
        opt = lambda a: None if a is None else a[mask]  # noqa: E731
        return EventFrame(
            event=opt(self.event),
            entity_type=opt(self.entity_type),
            entity_id=self.entity_id[mask],
            target_entity_type=opt(self.target_entity_type),
            target_entity_id=self.target_entity_id[mask],
            event_time_ms=self.event_time_ms[mask],
            properties=opt(self.properties),
            value=opt(self.value),
        )

    def with_event_names(self, names: Iterable[str]) -> "EventFrame":
        if self.event is None:
            raise ValueError(
                "event column not loaded: this frame came from a "
                "minimal scan (find_columnar(minimal=True)); rescan "
                "without minimal to filter by event name"
            )
        names = set(names)
        mask = np.fromiter((e in names for e in self.event), dtype=bool,
                           count=len(self))
        return self.select(mask)

    def property_column(
        self, name: str, default: float = np.nan
    ) -> np.ndarray:
        """Extract one float property as a column (uses pre-extracted
        ``value`` if available)."""
        if self.value is not None:
            return self.value
        assert self.properties is not None
        out = np.full(len(self), default, dtype=np.float64)
        for i, p in enumerate(self.properties):
            if p:
                v = p.get(name)
                if v is not None:
                    out[i] = float(v)
        return out

    def to_ratings(
        self,
        rating_property: Optional[str] = None,
        implicit_value: float = 1.0,
        user_index: Optional[StringIndex] = None,
        item_index: Optional[StringIndex] = None,
        dedup: str = "last",
    ) -> "Ratings":
        """Build contiguous-index COO ratings from (entity -> target) events.

        ``dedup``: 'last' keeps the latest event per (user, item) pair
        (matching the reference templates' intent of one rating per pair),
        'sum' accumulates (implicit feedback counts), 'none' keeps all.
        """
        if user_index is None:
            # one-pass dictionary build + encode (hash-based when pandas
            # is available — ~5x the dict path at 20M ids)
            users, u = StringIndex.factorize(self.entity_id)
        else:
            users = user_index
            u = users.encode(self.entity_id)
        if item_index is None:
            items, it = StringIndex.factorize(self.target_entity_id)
        else:
            items = item_index
            it = items.encode(self.target_entity_id)
        if rating_property is not None:
            v = self.property_column(rating_property)
        else:
            v = np.full(len(self), implicit_value, dtype=np.float64)
        ok = (u >= 0) & (it >= 0) & ~np.isnan(v)
        u, it, v, t = u[ok], it[ok], v[ok], self.event_time_ms[ok]
        u, it, v = dedup_coo(u, it, v, t, len(items), dedup)
        return Ratings(
            user_ix=u.astype(np.int32),
            item_ix=it.astype(np.int32),
            rating=v.astype(np.float32),
            users=users,
            items=items,
        )


@dataclass
class Ratings:
    """COO rating triples over contiguous indices + the id dictionaries."""

    user_ix: np.ndarray  # int32 [n]
    item_ix: np.ndarray  # int32 [n]
    rating: np.ndarray   # float32 [n]
    users: StringIndex
    items: StringIndex

    def __len__(self) -> int:
        return len(self.rating)

    @property
    def n_users(self) -> int:
        return len(self.users)

    @property
    def n_items(self) -> int:
        return len(self.items)


def events_to_frame(events: Iterable[Event]) -> EventFrame:
    """Generic Event objects -> frame (used by the memory backend; the
    SQLite backend reads columns directly)."""
    evs = list(events)
    n = len(evs)
    cols = {
        k: np.empty(n, dtype=object)
        for k in (
            "event", "entity_type", "entity_id",
            "target_entity_type", "target_entity_id", "properties",
        )
    }
    times = np.empty(n, dtype=np.int64)
    for i, e in enumerate(evs):
        cols["event"][i] = e.event
        cols["entity_type"][i] = e.entity_type
        cols["entity_id"][i] = e.entity_id
        cols["target_entity_type"][i] = e.target_entity_type
        cols["target_entity_id"][i] = e.target_entity_id
        cols["properties"][i] = e.properties.fields
        times[i] = time_millis(e.event_time)
    return EventFrame(
        event=cols["event"],
        entity_type=cols["entity_type"],
        entity_id=cols["entity_id"],
        target_entity_type=cols["target_entity_type"],
        target_entity_id=cols["target_entity_id"],
        event_time_ms=times,
        properties=cols["properties"],
    )
