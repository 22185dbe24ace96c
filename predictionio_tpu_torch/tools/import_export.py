"""Event export/import: JSON-lines files <-> event store.

Port of ``predictionio_tpu/tools/import_export.py`` (reference
`tools/export/EventsToFile.scala:30-104`,
`tools/imprt/FileToEvents.scala:30-95`) for JSON lines.  The import
scans the file with the native JSON-lines scanner
(``native/jsonl_scan.cpp``) in 64 MiB chunks and writes every chunk's
rows inside one ``store.bulk()`` scope; only lines the scanner flags go
through ``Event.from_json``.  The export composes wire JSON straight
from the stored rows.

Not ported yet (ROADMAP Queue 1): the ``.npz`` columnar and Parquet
formats and the MovieLens CSV import; they raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
from itertools import repeat
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import (
    F_ENTITY_ID,
    F_ENTITY_TYPE,
    F_EVENT,
    F_EVENT_ID,
    F_PR_ID,
    F_PROPERTIES,
    F_TARGET_ENTITY_ID,
    F_TARGET_ENTITY_TYPE,
    scan_events_jsonl,
)
from ..storage.event import (
    Event,
    format_time,
    from_millis,
    new_event_ids,
    now_utc,
    time_millis,
)
from ..storage.levents import EventStore

__all__ = [
    "export_events",
    "import_events",
    "import_events_columnar",
    "import_ratings_csv",
    "infer_format",
]

_BATCH = 5000
# chunk size for the native import scan; bounds peak host memory at
# roughly chunk + its per-line offset arrays regardless of file size
_NATIVE_CHUNK = 64 << 20


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to predictionio_tpu_torch yet (ROADMAP "
        "Queue 1); the port imports and exports JSON lines"
    )


def infer_format(path: str | Path, default: str = "json") -> str:
    """File format from extension, else content magic, else ``default``
    (``"json"``, ``"columnar"`` for npz, ``"parquet"``)."""
    p = str(path)
    if p.endswith(".npz"):
        return "columnar"
    if p.endswith(".parquet"):
        return "parquet"
    try:
        with open(p, "rb") as f:
            magic = f.read(4)
        if magic == b"PAR1":
            return "parquet"
        if magic[:2] == b"PK":
            return "columnar"
    except OSError:
        pass
    return default


def import_events(
    path: str | Path,
    store: EventStore,
    app_id: int,
    channel_id: int = 0,
    counts: Optional[dict] = None,
) -> int:
    """JSON-lines file -> event store; returns the number imported.

    Stores with the raw-row sink (``insert_raw_rows``, the SQLite store)
    take the native scan; others parse every line with
    ``Event.from_json``.  Either way the whole import runs in one
    ``store.bulk()`` scope (one commit, all or nothing).  ``counts``,
    when given, is filled with how many events took each branch:
    ``{"native": rows scanned natively, "python": lines re-parsed}``.
    """
    fmt = infer_format(path)
    if fmt != "json":
        raise _not_ported(f"importing {fmt} files")
    # table DDL before the transaction scope: sqlite auto-commits DDL,
    # which would break the all-or-nothing rollback guarantee
    store.init_channel(app_id, channel_id)
    tally = {"native": 0, "python": 0}
    if hasattr(store, "insert_raw_rows"):
        n = _import_events_native(path, store, app_id, channel_id, tally)
    else:
        n = _import_events_python(path, store, app_id, channel_id, tally)
    if counts is not None:
        counts.update(tally)
    return n


def _import_events_python(path, store, app_id, channel_id, tally) -> int:
    n = 0
    batch: list[Event] = []
    with open(path, encoding="utf-8") as f, store.bulk():
        for line in f:
            line = line.strip()
            if not line:
                continue
            batch.append(Event.from_json(json.loads(line)))
            if len(batch) >= _BATCH:
                store.insert_batch(batch, app_id, channel_id,
                                   validate=False)
                n += len(batch)
                batch = []
        if batch:
            store.insert_batch(batch, app_id, channel_id, validate=False)
            n += len(batch)
    tally["python"] += n
    return n


def _import_events_native(path, store, app_id, channel_id, tally) -> int:
    """The native scan, chunk by chunk.

    ``native/jsonl_scan.cpp`` extracts each event's storage-row fields
    (and the raw ``properties`` substring, stored as is: readers parse
    JSON text, so non-canonical spacing or key order is semantically
    identical) in one pass.  Lines it marks ``status=1`` (escapes, tags,
    validation failures, unusual timestamps) are re-parsed with the
    exact ``Event.from_json`` path, so errors and edge semantics match
    the portable importer.  Events without an eventTime get one shared
    import-time default.  The file is read in ``_NATIVE_CHUNK`` blocks
    split at line boundaries, so peak memory stays flat at any file
    size; all chunks flush inside one ``store.bulk()`` scope."""
    now_ms = time_millis(now_utc())
    imported = 0
    with open(path, "rb") as fh, store.bulk():
        leftover = b""
        while True:
            block = fh.read(_NATIVE_CHUNK)
            if not block:
                data, leftover = leftover, b""
            else:
                data = leftover + block
                nl = data.rfind(b"\n")
                if nl < 0:
                    # no complete line in the buffer yet (a single line
                    # longer than the chunk): keep reading
                    leftover = data
                    continue
                # the scanner would treat a truncated trailing line as a
                # whole line; split at the last newline and carry the rest
                leftover = data[nl + 1:]
                data = data[: nl + 1]
            if data:
                imported += _flush_scanned(
                    data, scan_events_jsonl(data), store, app_id,
                    channel_id, now_ms, tally,
                )
            if not block:
                break
    return imported


def _column(text, data: bytes, off: np.ndarray, ln: np.ndarray) -> list:
    """One string field of a run of scanned events, as a list (None
    where the event has no such field)."""
    n = len(off)
    if n == 0 or ln.max() < 0:
        return [None] * n
    pairs = zip(off.tolist(), ln.tolist())
    if text is None:
        return [data[a:a + b].decode() if b >= 0 else None for a, b in pairs]
    if ln.min() >= 0:
        return [text[a:a + b] for a, b in pairs]
    return [text[a:a + b] if b >= 0 else None for a, b in pairs]


def _flush_scanned(data: bytes, scan, store, app_id: int, channel_id: int,
                   now_ms: int, tally: dict) -> int:
    """Insert one scanned chunk's events: runs of natively scanned rows
    as raw rows, built a column at a time, and runs of flagged lines
    through ``Event.from_json``.  INSERT OR REPLACE makes a duplicate
    eventId last-line-wins, so the runs go in strictly in file order."""
    n, foff, flen, ev_ms, cr_ms, loff, llen, status = scan
    time_none = np.iinfo(np.int64).min  # TIME_NONE in jsonl_scan.cpp
    ids = new_event_ids(n)
    # an ASCII chunk (the common case) is decoded once and sliced as str:
    # its byte offsets are character offsets
    text = data.decode() if data.isascii() else None
    ev = np.where(ev_ms == time_none, now_ms, ev_ms).tolist()
    cr = np.where(cr_ms == time_none, now_ms, cr_ms).tolist()
    bounds = [0, *(np.flatnonzero(np.diff(status)) + 1).tolist(), n]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == b:
            continue
        if status[a]:
            events = [
                Event.from_json(json.loads(
                    data[loff[k]: loff[k] + llen[k]].decode()))
                for k in range(a, b)
            ]
            for s in range(0, len(events), _BATCH):
                store.insert_batch(events[s:s + _BATCH], app_id, channel_id,
                                   validate=False)
            tally["python"] += b - a
            continue
        col = [_column(text, data, foff[a:b, f], flen[a:b, f])
               for f in range(foff.shape[1])]
        rows = list(zip(
            [x or y for x, y in zip(col[F_EVENT_ID], ids[a:b])],
            col[F_EVENT],
            col[F_ENTITY_TYPE],
            col[F_ENTITY_ID],
            col[F_TARGET_ENTITY_TYPE],
            col[F_TARGET_ENTITY_ID],
            [x or "{}" for x in col[F_PROPERTIES]],
            ev[a:b],
            repeat("[]"),
            col[F_PR_ID],
            cr[a:b],
        ))
        store.insert_raw_rows(rows, app_id, channel_id)
        tally["native"] += b - a
    return n


def export_events(
    path: str | Path,
    store: EventStore,
    app_id: int,
    channel_id: int = 0,
    fmt: Optional[str] = None,
) -> int:
    """Event store -> JSON-lines file; returns the number exported.
    ``fmt`` (or the extension ``.npz``/``.parquet``) naming another
    format raises ``NotImplementedError``."""
    if fmt is None:
        # extension only: the file does not exist yet
        p = str(path)
        fmt = ("columnar" if p.endswith(".npz")
               else "parquet" if p.endswith(".parquet") else "json")
    if fmt in ("columnar", "parquet"):
        raise _not_ported(f"exporting {fmt} files")
    if fmt != "json":
        raise ValueError(f"unknown export format {fmt!r}")
    if hasattr(store, "iter_raw_rows"):
        return _export_json_fast(path, store, app_id, channel_id)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for e in store.find(app_id=app_id, channel_id=channel_id):
            f.write(json.dumps(e.to_json(), separators=(",", ":")))
            f.write("\n")
            n += 1
    return n


def _export_json_fast(path: str | Path, store, app_id: int,
                      channel_id: int) -> int:
    """Wire-format JSON lines composed from raw storage rows.

    Skips Event construction and property re-serialization: the stored
    ``properties`` text is spliced in as is (valid JSON; spacing may
    reflect the original import source rather than compact dumps).
    Field order and every other field's formatting match
    ``Event.to_json`` + ``json.dumps(separators=(",", ":"))``."""
    n = 0
    d = json.dumps  # escapes string fields exactly like the Event path
    # utf-8 explicitly: spliced properties text may carry raw non-ASCII
    # (the native importer stores source bytes as is)
    with open(path, "w", encoding="utf-8") as f:
        for (eid, event, etype, ent_id, tet, tei, props, ev_ms, _tags,
             pr_id, cr_ms) in store.iter_raw_rows(app_id, channel_id):
            parts = [
                f'{{"eventId":{d(eid)}',
                f'"event":{d(event)}',
                f'"entityType":{d(etype)}',
                f'"entityId":{d(ent_id)}',
                f'"properties":{props}',
                f'"eventTime":{d(format_time(from_millis(ev_ms)))}',
            ]
            if tet is not None:
                parts.append(f'"targetEntityType":{d(tet)}')
            if tei is not None:
                parts.append(f'"targetEntityId":{d(tei)}')
            if pr_id is not None:
                parts.append(f'"prId":{d(pr_id)}')
            parts.append(
                f'"creationTime":{d(format_time(from_millis(cr_ms)))}'
            )
            f.write(",".join(parts))
            f.write("}\n")
            n += 1
    return n


def import_events_columnar(path, store, app_id: int, channel_id: int = 0):
    """The reference's npz columnar import; not ported yet."""
    raise _not_ported("importing .npz columnar files")


def import_ratings_csv(path, store, app_id: int, channel_id: int = 0,
                       **kwargs):
    """The reference's MovieLens CSV import; not ported yet."""
    raise _not_ported("importing MovieLens CSV ratings")
