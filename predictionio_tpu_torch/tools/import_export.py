"""Event export/import: files <-> event store.

Port of ``predictionio_tpu/tools/import_export.py`` (reference
`tools/export/EventsToFile.scala:30-104`,
`tools/imprt/FileToEvents.scala:30-95`).  Three formats, inferred from
the extension or the content (:func:`infer_format`), go through the same
two entry points:

* JSON lines: the import scans the file with the native JSON-lines
  scanner (``native/jsonl_scan.cpp``) in 64 MiB chunks and writes every
  chunk's rows inside one ``store.bulk()`` scope; only lines the scanner
  flags go through ``Event.from_json``.  The export composes wire JSON
  straight from the stored rows.
* ``.npz`` columnar (one string array per wire field): the import
  validates and inserts 5,000 rows a batch, with no bulk scope, as the
  reference's does; a batch of plain rows goes to the store's raw-row
  sink, any other batch through ``Event.from_json``.
* Parquet (pyarrow, imported where it is used): every row through
  ``Event.from_json``, inserted in one bulk scope.

:func:`import_ratings_csv` reads a MovieLens ratings file
(``user::item::rating``) as rate events.
"""

from __future__ import annotations

import json
import os
from itertools import islice, repeat
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
    DataMap,
    Event,
    EventValidationError,
    format_time,
    from_millis,
    new_event_ids,
    now_utc,
    time_millis,
    validate_event,
)
from ..storage.levents import EventStore

__all__ = [
    "columnar_path",
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
# a JSON-lines file at least this big goes to a sharded store through
# one worker process a shard (tools/shard_import.py).  The workers cost
# 8-9 s to start; one writer wins below the crossover, which fell
# between heads of 128 MiB (12.1 against 14.4 s) and 256 MiB (25.0
# against 15.8 s) of the ML-20M file on an H100 host (chip_smoke.py
# --store), about 150 MiB by interpolation
_PROCESS_MIN_BYTES = 150 << 20


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
    """File -> event store; returns the number imported.

    A Parquet or ``.npz`` file (:func:`infer_format`) goes to its own
    reader.  A JSON-lines file on a store with the raw-row sink
    (``insert_raw_rows``, the SQLite stores) takes the native scan;
    others parse every line with ``Event.from_json``.  Either way the
    whole JSON-lines import runs in one ``store.bulk()`` scope (one
    commit, all or nothing).  ``counts``, when given, is filled for a
    JSON-lines file with how many events took each branch:
    ``{"native": rows scanned natively, "python": lines re-parsed}``.
    """
    fmt = infer_format(path)
    if fmt == "parquet":
        return _import_parquet(path, store, app_id, channel_id)
    if fmt == "columnar":
        return import_events_columnar(path, store, app_id, channel_id)
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
    size; all chunks flush inside one ``store.bulk()`` scope.  A sharded
    store that writes from worker processes (:mod:`.shard_import`) hands
    each shard's lines to a process of its own instead, for a file of
    ``_PROCESS_MIN_BYTES`` or more."""
    now_ms = time_millis(now_utc())
    files = (getattr(store, "import_shard_files", lambda: None)()
             if os.path.getsize(path) >= _PROCESS_MIN_BYTES else None)
    if files is not None:
        from .shard_import import import_by_shard

        return import_by_shard(path, store, files, app_id, channel_id,
                               now_ms, tally)
    with open(path, "rb") as fh, store.bulk():
        return insert_jsonl(_line_blocks(fh), store, app_id, channel_id,
                            now_ms, tally)


def _line_blocks(fh):
    """The file's bytes in ``_NATIVE_CHUNK`` blocks, each ending at a
    line boundary (the scanner would take a truncated trailing line for
    a whole one, so the rest is carried into the next block)."""
    leftover = b""
    while True:
        block = fh.read(_NATIVE_CHUNK)
        if not block:
            if leftover:
                yield leftover
            return
        data = leftover + block
        nl = data.rfind(b"\n")
        if nl < 0:
            # no complete line in the buffer yet (a single line longer
            # than the chunk): keep reading
            leftover = data
            continue
        leftover = data[nl + 1:]
        yield data[: nl + 1]


def insert_jsonl(blocks, store, app_id: int, channel_id: int, now_ms: int,
                 tally: dict) -> int:
    """Every event of ``blocks`` (JSON lines, each block ending at a line
    boundary) into ``store``, the caller holding the bulk scope; the
    number of events."""
    return sum(
        _flush_scanned(data, scan_events_jsonl(data), store, app_id,
                       channel_id, now_ms, tally)
        for data in blocks if data
    )


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
    """Event store -> file; returns the number exported.

    ``fmt``: ``"json"`` (JSON lines, the default), ``"columnar"`` (an
    npz of per-field string arrays, written to :func:`columnar_path`)
    or ``"parquet"`` (the reference's SparkSQL-Parquet option, through
    pyarrow).  Without ``fmt`` the extensions ``.npz`` and ``.parquet``
    name their formats."""
    if fmt is None:
        # extension only: the file does not exist yet
        p = str(path)
        fmt = ("columnar" if p.endswith(".npz")
               else "parquet" if p.endswith(".parquet") else "json")
    if fmt == "parquet":
        return _export_parquet(path, store, app_id, channel_id)
    if fmt == "columnar":
        # np.savez appends '.npz' itself; normalize up front so the
        # reported filename is the one actually written
        return _export_columnar(columnar_path(path), store, app_id,
                                channel_id)
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


def columnar_path(path: str | Path) -> str:
    """The filename a columnar export actually writes."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


# the string columns of the npz format, in the reference's order; the
# file holds "properties" besides, and "" stands for a missing field
_COLUMNS = (
    "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "eventTime", "eventId", "prId", "creationTime",
)

_PARQUET_COLUMNS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "tags", "prId",
    "creationTime",
)

# distinct values a per-export cache keeps (property and tag texts)
_MEMO_CAP = 1 << 16
# rows a columnar export reads from the store at a time
_EXPORT_CHUNK = 1 << 16


def _memo(fn):
    """``fn`` of one argument, cached for the first ``_MEMO_CAP``
    distinct arguments (rating properties repeat, tags too)."""
    cache: dict = {}

    def call(x):
        out = cache.get(x)
        if out is None:
            out = fn(x)
            if len(cache) < _MEMO_CAP:
                cache[x] = out
        return out

    return call


def _compact(props: dict) -> str:
    """A properties dict as the formats store it: compact JSON, ``""``
    when empty."""
    return json.dumps(props, separators=(",", ":")) if props else ""


def _iso_times(ms: list) -> list:
    """``format_time(from_millis(m))`` of each stored time.  Within 2**32
    seconds of the epoch the float steps of ``from_millis`` land on the
    exact millisecond, so the strings are numpy's; elsewhere each goes
    through ``datetime``."""
    a = np.asarray(ms, dtype=np.int64)
    if len(a) and int(np.abs(a).max()) < (1 << 32) * 1000:
        return np.char.add(np.datetime_as_string(
            a.astype("datetime64[ms]"), unit="ms"), "Z").tolist()
    return [format_time(from_millis(m)) for m in ms]


def _chunks(it, size: int):
    it = iter(it)
    while chunk := list(islice(it, size)):
        yield chunk


def _wire_chunks(store, app_id: int, channel_id: int, size: int):
    """Every stored event in ``find``'s order, ``size`` at a time, as
    columns of wire fields (``_PARQUET_COLUMNS``): ``Event.to_json()``'s
    values, None for an absent optional field, ``properties`` as
    :func:`_compact` text and ``tags`` as JSON text.  Stores with
    ``iter_raw_rows`` are read as raw rows, without an ``Event`` a row;
    others through ``find``."""
    if not hasattr(store, "iter_raw_rows"):
        events = store.find(app_id=app_id, channel_id=channel_id)
        for chunk in _chunks(events, size):
            ds = [e.to_json() for e in chunk]
            cols = {c: [d.get(c) for d in ds] for c in _PARQUET_COLUMNS}
            cols["properties"] = [_compact(d.get("properties") or {})
                                  for d in ds]
            cols["tags"] = [json.dumps(list(e.tags)) for e in chunk]
            yield cols
        return
    props_of = _memo(lambda text: _compact(json.loads(text)))
    tags_of = _memo(lambda text: json.dumps(list(json.loads(text))))
    for rows in _chunks(store.iter_raw_rows(app_id, channel_id), size):
        (eid, event, etype, ent_id, tet, tei, props, ev_ms, tags, pr_id,
         cr_ms) = map(list, zip(*rows))
        yield {"eventId": eid, "event": event, "entityType": etype,
               "entityId": ent_id, "targetEntityType": tet,
               "targetEntityId": tei,
               "properties": [props_of(x) for x in props],
               "eventTime": _iso_times(ev_ms),
               "tags": [tags_of(x) for x in tags], "prId": pr_id,
               "creationTime": _iso_times(cr_ms)}


def _export_columnar(path: str | Path, store: EventStore, app_id: int,
                     channel_id: int) -> int:
    """Events -> one compressed npz of string columns (``_COLUMNS`` and
    ``properties``, compact JSON), ``""`` for a missing field."""
    cols: dict[str, list[str]] = {c: [] for c in (*_COLUMNS, "properties")}
    for chunk in _wire_chunks(store, app_id, channel_id, _EXPORT_CHUNK):
        for c in _COLUMNS:
            cols[c] += [x or "" for x in chunk[c]]
        cols["properties"] += chunk["properties"]
    n = len(cols["event"])
    np.savez_compressed(
        path, **{k: np.asarray(v, dtype=np.str_) for k, v in cols.items()}
    )
    return n


def _export_parquet(path: str | Path, store: EventStore, app_id: int,
                    channel_id: int) -> int:
    """Events -> one Parquet file of string columns (wire-format fields;
    ``properties`` and ``tags`` as JSON text, times as ISO-8601),
    written in ``_BATCH``-row record batches so that no column is held
    whole."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    schema = pa.schema([(c, pa.string()) for c in _PARQUET_COLUMNS])
    n = 0
    with pq.ParquetWriter(str(path), schema) as writer:
        for chunk in _wire_chunks(store, app_id, channel_id, _BATCH):
            chunk["properties"] = [x or "{}" for x in chunk["properties"]]
            writer.write_batch(pa.record_batch(
                [pa.array(chunk[c], pa.string()) for c in _PARQUET_COLUMNS],
                schema=schema,
            ))
            n += len(chunk["event"])
    return n


def _import_parquet(path: str | Path, store: EventStore, app_id: int,
                    channel_id: int) -> int:
    """Parquet -> event store, in one bulk scope.  Each record batch is
    inserted as the reference's: every row through ``Event.from_json``
    (which validates), the events with ``validate=False``.  On a store
    with the raw-row sink, a file of string columns takes the same rows
    column-wise where a batch is plain (:func:`_plain_rows`)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    opt = ("eventId", "targetEntityType", "targetEntityId", "eventTime",
           "prId", "creationTime")
    imported = 0
    store.init_channel(app_id, channel_id)
    pf = pq.ParquetFile(str(path))
    schema = pf.schema_arrow
    raw = (hasattr(store, "insert_raw_rows")
           and {"event", "entityType", "entityId"} <= set(schema.names)
           and all(pa.types.is_string(t) or pa.types.is_large_string(t)
                   for t in schema.types))
    with store.bulk():
        for rb in pf.iter_batches(batch_size=_BATCH):
            data = {name: rb.column(i).to_pylist()
                    for i, name in enumerate(rb.schema.names)}
            n = rb.num_rows
            none_col = [None] * n
            rows = _plain_rows({c: data.get(c, none_col) for c in (
                *_PARQUET_COLUMNS,)}) if raw and n else None
            if rows is not None:
                store.insert_raw_rows(rows, app_id, channel_id)
                imported += n
                continue
            opt_cols = {name: data.get(name, none_col) for name in opt}
            props_col = data.get("properties", none_col)
            tags_col = data.get("tags", none_col)
            batch: list[Event] = []
            for k in range(n):
                d = {
                    "event": data["event"][k],
                    "entityType": data["entityType"][k],
                    "entityId": data["entityId"][k],
                }
                for name in opt:
                    v = opt_cols[name][k]
                    if v is not None:
                        d[name] = v
                props = props_col[k]
                if props:
                    d["properties"] = json.loads(props)
                tags = tags_col[k]
                if tags:
                    d["tags"] = (json.loads(tags) if isinstance(tags, str)
                                 else list(tags))
                batch.append(Event.from_json(d))
            if batch:
                store.insert_batch(batch, app_id, channel_id,
                                   validate=False)
                imported += len(batch)
    return imported


def import_events_columnar(path: str | Path, store: EventStore, app_id: int,
                           channel_id: int = 0) -> int:
    """npz columnar file (see :func:`export_events`) -> event store;
    returns the number imported.

    ``_BATCH`` rows at a time, each batch validated and inserted on its
    own (no bulk scope: the batches before a bad row stay stored).  A
    batch of plain rows on a store with the raw-row sink is checked
    column-wise (:func:`_plain_rows`) and written as raw rows; any other
    batch goes row by row through ``Event.from_json``, which raises the
    reference's errors."""
    data = np.load(path, allow_pickle=False)
    n = len(data["event"])
    if n == 0:
        return 0
    # one read of each column (an NpzFile reads a member anew per access)
    cols = {c: data[c] for c in (*_COLUMNS, "properties")}
    raw = hasattr(store, "insert_raw_rows") and all(
        a.dtype.kind == "U" and a.shape == (n,) for a in cols.values())
    total = 0
    for s in range(0, n, _BATCH):
        chunk = {c: a[s:s + _BATCH].tolist() for c, a in cols.items()}
        rows = None
        if raw:
            # in the npz format "" is a missing field
            rows = _plain_rows({c: [x or None for x in v]
                                if c not in ("event", "entityType",
                                             "entityId") else v
                                for c, v in chunk.items()})
        if rows is not None:
            store.insert_raw_rows(rows, app_id, channel_id)
        else:
            store.insert_batch(_events_of(chunk), app_id, channel_id)
        total += len(chunk["event"])
    return total


def _events_of(chunk: dict) -> list[Event]:
    """The reference's row path for npz rows: each row's non-empty
    fields through ``Event.from_json``."""
    lists = {c: [str(x) for x in v] for c, v in chunk.items()}
    out = []
    for row in range(len(lists["event"])):
        d = {c: lists[c][row] for c in _COLUMNS if lists[c][row]}
        props = lists["properties"][row]
        if props:
            d["properties"] = json.loads(props)
        out.append(Event.from_json(d))
    return out


def _millis(times: list, now_ms: int) -> Optional[list]:
    """``time_millis`` of each wire time as ``Event.from_json`` reads it:
    ``now_ms`` for all when none is given, else each in ``format_time``'s
    form ``YYYY-MM-DDTHH:MM:SS.mmmZ`` (None when one is absent or has
    another form).  The float steps are ``datetime.timestamp()``'s:
    microseconds / 1e6, times 1000, truncated."""
    if not any(times):
        return [now_ms] * len(times)
    a = np.asarray(times)
    if a.dtype != np.dtype("<U24"):
        return None
    cp = a.view(np.uint32).reshape(len(a), 24)
    if not ((cp[:, 10] == ord("T")).all() and (cp[:, 19] == ord(".")).all()
            and (cp[:, 23] == ord("Z")).all()):
        return None
    try:
        ms = a.astype("<U23").astype("datetime64[ms]").astype(np.int64)
    except ValueError:
        return None
    return np.trunc((ms * 1000) / 1e6 * 1000.0).astype(np.int64).tolist()


def _plain_rows(col: dict) -> Optional[list]:
    """The storage rows ``Event.from_json`` and ``insert_batch`` would
    write for a batch of wire columns (strings; None for an absent
    field), built column-wise, or None unless every row is plain: event,
    entity type and id non-empty, target type and id both given or both
    absent, times absent or in ``format_time``'s form, properties absent
    or a JSON object, tags absent or empty, and every distinct (event,
    entity type, target type, properties) passing ``validate_event``."""
    ev, et, eid = col["event"], col["entityType"], col["entityId"]
    tet, tei = col["targetEntityType"], col["targetEntityId"]
    if not (all(ev) and all(et) and all(eid)
            and all(a is None and b is None or a and b
                    for a, b in zip(tet, tei))
            and all(t in (None, "", "[]") for t in col.get(
                "tags", ()))):
        return None
    now_ms = time_millis(now_utc())
    ev_ms = _millis(col["eventTime"], now_ms)
    cr_ms = _millis(col["creationTime"], now_ms)
    if ev_ms is None or cr_ms is None:
        return None
    props_text: dict = {}
    for text in set(col["properties"]):
        try:
            props = json.loads(text) if text else {}
        except json.JSONDecodeError:
            return None
        if not isinstance(props, dict):
            return None
        props_text[text] = (props, json.dumps(props, separators=(",", ":")))
    try:
        for e, t, tt, p in set(zip(ev, et, tet, col["properties"])):
            validate_event(Event(
                event=e, entity_type=t, entity_id="x",
                target_entity_type=tt, target_entity_id="y" if tt else None,
                properties=DataMap(props_text[p][0])))
    except EventValidationError:
        return None
    fresh = new_event_ids(len(ev))
    return list(zip(
        [x or y for x, y in zip(col["eventId"], fresh)],
        ev, et, eid, tet, tei,
        [props_text[p][1] for p in col["properties"]],
        ev_ms,
        repeat("[]"),
        col["prId"],
        cr_ms,
    ))


def import_ratings_csv(
    path: str | Path,
    store: EventStore,
    app_id: int,
    channel_id: int = 0,
    event: str = "rate",
    delimiter: str = "::",
    has_header: bool = False,
) -> int:
    """MovieLens-style ratings file (user<delim>item<delim>rating[...])
    -> rate events, the recommendation template's quickstart import;
    returns the number imported.

    Every event gets the same import time.  Stores with the raw-row
    sink take rows built straight from the file; others ``Event``
    objects.  The event name is validated once (it is the same for every
    row), and an empty user or item id raises the ``EventValidationError``
    that ``validate_event`` would."""
    validate_event(Event(event=event, entity_type="user", entity_id="x",
                         target_entity_type="item", target_entity_id="y",
                         properties=DataMap({"rating": 1.0})))
    raw = hasattr(store, "insert_raw_rows")
    n = 0
    batch: list = []
    now_ms = time_millis(now_utc())
    ids = iter([])
    store.init_channel(app_id, channel_id)

    def flush():
        nonlocal n, batch
        if not batch:
            return
        if raw:
            store.insert_raw_rows(batch, app_id, channel_id)
        else:
            store.insert_batch(batch, app_id, channel_id)
        n += len(batch)
        batch = []

    with open(path) as f, store.bulk():
        if has_header:
            next(f, None)
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(delimiter)
            u, i, r = parts[0], parts[1], float(parts[2])
            if raw:
                if not u:
                    raise EventValidationError(
                        "entityId must not be empty string."
                    )
                if not i:
                    raise EventValidationError(
                        "targetEntityId must not be empty string."
                    )
                eid = next(ids, None)
                if eid is None:
                    ids = iter(new_event_ids(_BATCH))
                    eid = next(ids)
                batch.append((
                    eid, event, "user", u, "item", i,
                    '{"rating":%s}' % json.dumps(r), now_ms, "[]",
                    None, now_ms,
                ))
            else:
                batch.append(Event(
                    event=event, entity_type="user", entity_id=u,
                    target_entity_type="item", target_entity_id=i,
                    properties=DataMap({"rating": r}),
                ))
            if len(batch) >= _BATCH:
                flush()
        flush()
    return n
