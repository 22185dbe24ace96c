"""Event-store watermark cursor for incremental fold-in.

Port of ``predictionio_tpu/live/watermark.py`` (host code, copied: the
same cursor algebra, the same ``foldin_watermark.json`` file, so either
package resumes from the other's cursor).  The pio-live scan
primitive: a strictly-increasing rowid high-water mark per (app,
channel), persisted as JSON next to the model it feeds, plus the scan
that turns "rows since the cursor" into deduplicated rating triples
ready for the fold-in solver.

Why rowid and not event_time: event times are client-supplied and
arbitrarily out of order (imports, backfills), while sqlite's rowid is
assigned in commit order — `SQLiteEventStore.find_rows_since` pages it
off the table B-tree.  An ``INSERT OR REPLACE`` re-keys the replaced
event past the watermark, so corrections re-enter the next scan, which
is exactly what an incremental solver wants.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Watermark", "WatermarkStore", "ScanBatch", "scan_new_ratings",
    "cursor_is_zero", "cursor_would_regress", "merge_cursors",
]

WATERMARK_FILE = "foldin_watermark.json"


# -- cursor algebra ----------------------------------------------------------
#
# A cursor is an int rowid (single-file store) or a JSON shard-vector
# string '{"0": r0, "1": r1, ...}' (ShardedSQLiteEventStore) — the
# per-shard fold-in watermark.  Both kinds flow through the same
# watermark files / delta metadata; these helpers are the only places
# that look inside.


def _as_dict(c):
    if isinstance(c, str):
        try:
            d = json.loads(c)
        except json.JSONDecodeError:
            return None
        if isinstance(d, dict):
            return {str(k): int(v) for k, v in d.items()}
    return None


def cursor_is_zero(c) -> bool:
    """True for the never-folded starting cursor (0 / empty / all-zero
    vector)."""
    d = _as_dict(c)
    if d is not None:
        return all(v == 0 for v in d.values())
    return not c or int(c) == 0


def cursor_would_regress(prev, new) -> bool:
    """Whether replacing ``prev`` with ``new`` moves ANY component
    backwards (the strictly-increasing watermark contract, per shard).
    Mixed int/vector kinds regress unless the loser is zero — a store
    swap mid-chain must be refused, not silently re-keyed."""
    dp, dn = _as_dict(prev), _as_dict(new)
    if dp is None and dn is None:
        return int(new or 0) < int(prev or 0)
    if dp is not None and dn is not None:
        return any(dn.get(k, 0) < v for k, v in dp.items())
    # kind change: fine only when the previous cursor is still zero
    return not cursor_is_zero(prev)


def merge_cursors(a, b):
    """Component-wise max of two cursors of the SAME kind (zero merges
    with anything) — how the daemon reconciles the watermark file with
    the delta chain's recorded high-water on restart."""
    if cursor_is_zero(a):
        return b
    if cursor_is_zero(b):
        return a
    da, db = _as_dict(a), _as_dict(b)
    if da is None and db is None:
        return max(int(a), int(b))
    if da is not None and db is not None:
        keys = set(da) | set(db)
        return json.dumps(
            {k: max(da.get(k, 0), db.get(k, 0)) for k in sorted(keys)},
            sort_keys=True, separators=(",", ":"),
        )
    raise ValueError(
        f"cannot merge cursor kinds {type(a).__name__} and "
        f"{type(b).__name__} ({a!r} vs {b!r}); the event store "
        "backend changed mid-chain"
    )


@dataclass
class Watermark:
    app_id: int
    channel_id: int = 0
    # last event-store cursor folded in: an int rowid, or the sharded
    # store's JSON shard-vector string (see cursor algebra above)
    rowid: "int | str" = 0
    seq: int = 0     # last delta-chain seq produced from it


class WatermarkStore:
    """Atomic JSON persistence of per-(app, channel) watermarks.

    Lives next to the model artifacts
    (``<model_data_dir>/<instance_id>/foldin_watermark.json``) so the
    cursor travels with the model it describes: a redeploy from the
    same instance resumes where the last fold-in left off, and a fresh
    full retrain (new instance dir) starts a fresh cursor.

    Crash ordering: the daemon writes the delta file FIRST, this file
    second.  A crash between the two replays the same events into a
    duplicate-numbered... no — into the NEXT seq; the scan is
    deterministic and row solves are absolute values, and appended ids
    re-resolve to their existing indices (``StringIndex.append`` is
    idempotent), so a replayed window patches rows to the same values
    instead of corrupting.  The store also refuses to move a cursor
    backwards, so a stale writer cannot roll the chain back.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def _load_raw(self) -> dict:
        try:
            return json.loads(self.path.read_text())
        except FileNotFoundError:
            return {"version": 1, "cursors": {}}
        except (json.JSONDecodeError, OSError):
            # a torn watermark file only costs a re-scan window
            return {"version": 1, "cursors": {}}

    def get(self, app_id: int, channel_id: int = 0) -> Watermark:
        cur = self._load_raw()["cursors"].get(f"{app_id}:{channel_id}")
        if not cur:
            return Watermark(app_id=app_id, channel_id=channel_id)
        rowid = cur.get("rowid", 0)
        return Watermark(
            app_id=app_id,
            channel_id=channel_id,
            rowid=rowid if isinstance(rowid, str) else int(rowid),
            seq=int(cur.get("seq", 0)),
        )

    def advance(self, wm: Watermark) -> None:
        raw = self._load_raw()
        key = f"{wm.app_id}:{wm.channel_id}"
        prev = raw["cursors"].get(key, {})
        if cursor_would_regress(prev.get("rowid", 0), wm.rowid):
            raise ValueError(
                f"watermark for {key} would move backwards "
                f"({prev.get('rowid')} -> {wm.rowid})"
            )
        raw["cursors"][key] = {
            "rowid": (wm.rowid if isinstance(wm.rowid, str)
                      else int(wm.rowid)),
            "seq": int(wm.seq),
            "updatedAt": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(raw, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


@dataclass
class ScanBatch:
    """Deduplicated rating triples from one watermark window."""

    user_ids: list[str] = field(default_factory=list)
    item_ids: list[str] = field(default_factory=list)
    values: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float32)
    )
    n_events: int = 0
    cursor: "int | str" = 0       # the window's start cursor
    new_cursor: "int | str" = 0   # the high-water cursor consumed


def scan_new_ratings(
    es,
    app_id: int,
    channel_id: int = 0,
    cursor: int = 0,
    event_names: Sequence[str] = ("rate",),
    rating_property: Optional[str] = "rating",
    entity_type: Optional[str] = "user",
    limit: Optional[int] = None,
    tolerate_unavailable: bool = False,
) -> ScanBatch:
    """Rows past the watermark -> rating triples, matching the training
    read's semantics: explicit mode (``rating_property`` set) keeps the
    LAST value per (user, item) within the window; implicit mode counts
    1.0 per event.  Events missing the rating property, of another
    entity type, or without a target are skipped (they still advance
    the cursor — the watermark is a storage cursor, not a rating
    counter).

    Requires a store exposing :meth:`find_rows_since` (the SQLite
    backend); callers feature-test with ``hasattr``.

    ``tolerate_unavailable`` (sharded stores only, pio-levee): a shard
    whose owner is down contributes no rows and keeps its vector-cursor
    component FROZEN — the fold-in stalls on exactly that component and
    resumes without loss when the owner returns, while healthy shards'
    components keep advancing.
    """
    kw = {}
    if tolerate_unavailable:
        # sharded-store-only kwarg; single-file stores have no shard
        # to lose, so the flag is simply not passed
        kw["tolerate_unavailable"] = True
    rows, new_cursor = es.find_rows_since(
        app_id, channel_id, cursor=cursor, limit=limit,
        event_names=list(event_names), **kw,
    )
    implicit = rating_property is None
    # key -> running value; rowid order means "last wins" is insertion
    # order over this dict
    agg: dict[tuple[str, str], float] = {}
    n_used = 0
    for r in rows:
        # r = (rowid, event_id, event, entity_type, entity_id,
        #      target_entity_type, target_entity_id, properties,
        #      event_time, tags, pr_id, creation_time)
        etype, eid = r[3], r[4]
        target = r[6]
        if entity_type is not None and etype != entity_type:
            continue
        if target is None:
            continue
        if implicit:
            v = 1.0
        else:
            try:
                v = json.loads(r[7]).get(rating_property)
            except (json.JSONDecodeError, AttributeError):
                v = None
            if v is None:
                continue
            v = float(v)
        key = (str(eid), str(target))
        if implicit:
            agg[key] = agg.get(key, 0.0) + v
        else:
            # re-insert to keep "last wins" while preserving first-seen
            # iteration order for everything else
            agg[key] = v
        n_used += 1
    users = [k[0] for k in agg]
    items = [k[1] for k in agg]
    return ScanBatch(
        user_ids=users,
        item_ids=items,
        values=np.asarray(list(agg.values()), np.float32),
        n_events=len(rows),
        # cursors pass through OPAQUELY: int rowid (single file) or the
        # sharded store's shard-vector string
        cursor=cursor,
        new_cursor=new_cursor,
    )
