"""SQLite event store backend.

Copy of ``predictionio_tpu/storage/sqlite_events.py`` for the port, with
the same schema and schema version, so an ``eventdata.db`` written by
either package is read by the other.  One SQLite file per storage
source, one table per (app, channel), mirroring the reference's
table-per-app/channel HBase layout (`HBEventsUtil.scala:51-57`); the
composite indexes below make entity-scoped time-range scans cheap, and
WAL mode with a per-store write lock gives concurrent readers and a
single writer.

The batch read path (:meth:`SQLiteEventStore.find_columnar`) reads
straight into NumPy arrays, the `PEvents` analogue
(`HBPEvents.scala:66-199`).  :meth:`SQLiteEventStore.find_ratings` fuses
the scan and the string-id encode in one native pass
(``native/sqlite_scan.cpp``) and takes the reference's Python branch,
``find_columnar(minimal=True) -> to_ratings``, only for the data reasons
the reference does.  Both reads may be served from the scan snapshot
cache (``scan_cache.py``).  The sharded store (``sharded_events.py``)
is N of these files.  The incremental scans (:meth:`SQLiteEventStore.
find_rows_since` and its cursor helpers) page the rows written past a
rowid watermark for the fold-in (``live/``).
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import functools
import itertools
import json
import logging
import os
import re
import secrets
import sqlite3
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from ..resilience.policy import check_deadline
from ._sqlite_util import SerializedConnection
from .columnar import EventFrame, Ratings
from .event import (
    DataMap,
    Event,
    from_millis,
    new_event_id,
    new_event_ids,
    time_millis,
    validate_event,
)
from .levents import NO_TARGET, EventStore, TargetFilter

__all__ = ["SQLiteEventStore", "SCHEMA_VERSION", "event_to_row"]


def event_to_row(event: Event, eid: str) -> tuple:
    """The 11-column storage row for an event: the events table's
    schema, shared with the JAX package's importer and ingest WAL."""
    return (
        eid,
        event.event,
        event.entity_type,
        event.entity_id,
        event.target_entity_type,
        event.target_entity_id,
        json.dumps(event.properties.to_json(), separators=(",", ":")),
        time_millis(event.event_time),
        json.dumps(list(event.tags)),
        event.pr_id,
        time_millis(event.creation_time),
    )

logger = logging.getLogger(__name__)

# Versioned schema + forward migrations — the capability the reference
# ships as 0.8.x->0.9 HBase upgrade tooling
# (`data/.../storage/hbase/upgrade/Upgrade.scala`): a schema change must
# not strand existing event DBs (VERDICT r4 #7).  The version is stamped
# in the SQLite header (``PRAGMA user_version``); opening a store runs
# every migration from the DB's stamped version up to SCHEMA_VERSION in
# one transaction, and refuses (loudly) a DB stamped NEWER than this
# framework understands instead of corrupting it.
#
# v0 = pre-versioning DBs (rounds before stamping existed): same column
#      layout, but index/aux-table presence varied — the 0->1 migration
#      makes all of them certain.
# v1 = current: 11-column events tables, 3 composite indexes,
#      _scan_versions aux table, header stamped.
SCHEMA_VERSION = 1


# the per-table secondary indexes, ONE definition: table schema, the
# 0->1 migration, and the bulk-import defer/rebuild (names AND create
# statements) all derive from this — adding a 4th index here updates
# every consumer at once
_INDEXES = (
    ("time", "event_time"),
    ("entity", "entity_type, entity_id, event_time"),
    ("name", "event, event_time"),
)
_INDEX_SQL = tuple(
    f"CREATE INDEX IF NOT EXISTS {{t}}_{sfx} ON {{t}} ({cols})"
    for sfx, cols in _INDEXES
)
_INDEX_NAMES = tuple(f"{{t}}_{sfx}" for sfx, _ in _INDEXES)


def _migrate_0_to_1(conn: sqlite3.Connection) -> None:
    """Bring a pre-versioning DB to v1: ensure the aux table and every
    per-table index exists for each events table already in the file.
    Purely additive — legacy rows are untouched and stay readable."""
    tables = [
        r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name LIKE 'events\\_%' ESCAPE '\\'"
        )
    ]
    conn.execute(
        "CREATE TABLE IF NOT EXISTS _scan_versions "
        "(tbl TEXT PRIMARY KEY, v INTEGER NOT NULL)"
    )
    for t in tables:
        for stmt in _INDEX_SQL:
            conn.execute(stmt.format(t=t))


# version -> migration to version+1; future schema changes append here
_MIGRATIONS = {0: _migrate_0_to_1}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS {table} (
  event_id TEXT PRIMARY KEY,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL,
  event_time INTEGER NOT NULL,
  tags TEXT NOT NULL,
  pr_id TEXT,
  creation_time INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS _scan_versions (
  tbl TEXT PRIMARY KEY,
  v INTEGER NOT NULL
);
""" + "".join(
    # index DDL derived from _INDEX_SQL so fresh tables, the 0->1
    # migration, and the bulk defer/rebuild can never disagree
    s.replace("{t}", "{table}") + ";\n" for s in _INDEX_SQL
)


# the row of ``_scan_versions`` that holds the file's token (events
# tables are named ``events_<app>[_<channel>]``)
_TOKEN_ROW = "_file_token"


def _table_name(app_id: int, channel_id: int) -> str:
    # mirrors events_<appId>[_<channelId>] (HBEventsUtil.scala:51-57)
    return f"events_{app_id}" if channel_id == 0 else f"events_{app_id}_{channel_id}"


# rows one INSERT of insert_raw_rows binds: 90 x 11 columns stays within
# the 999 host parameters of sqlite's most conservative build
_ROWS_PER_INSERT = 90


@functools.lru_cache(maxsize=64)
def _multi_insert(table: str, n_rows: int) -> str:
    """``INSERT OR REPLACE`` of ``n_rows`` 11-column rows into ``table``
    in one statement."""
    return (f"INSERT OR REPLACE INTO {table} VALUES "
            + ",".join(["(?,?,?,?,?,?,?,?,?,?,?)"] * n_rows))


class SQLiteEventStore(EventStore):
    def __init__(self, path: str | Path = ":memory:",
                 lock_name: Optional[str] = None):
        if not isinstance(path, (str, Path)):
            # str(dict) would silently become a garbage FILENAME
            raise TypeError(
                f"path must be str/Path, got {type(path).__name__} "
                "(pass conf['path'], not the conf dict)"
            )
        self._path = str(path)
        # pio-scope opt-in (``lock_name``): the sharded store names
        # each shard's writer lock so per-shard contention books under
        # pio_lock_wait_seconds{lock="store_shard_<i>"}; the default
        # single-file store keeps a plain RLock
        if lock_name is not None:
            from ..obs.scope import TimedLock

            self._lock = TimedLock(lock_name, reentrant=True)
        else:
            self._lock = threading.RLock()
        self._local = threading.local()
        self._known_tables: set[str] = set()
        # :memory: must share one connection across threads; wrap it so
        # interleaved multi-thread statements serialize under the lock
        # (file-backed stores use per-thread connections instead)
        self._shared = self._path == ":memory:"
        if self._shared:
            self._conn_shared = SerializedConnection(
                self._connect(), self._lock
            )
        else:
            # touch eagerly: schema-version stamping/migration (and the
            # newer-than-framework refusal) must happen at OPEN, not on
            # whichever thread's first query happens to connect
            self._conn

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._path, check_same_thread=False)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        # without a busy timeout sqlite raises SQLITE_BUSY *immediately*
        # on any cross-connection contention (e.g. a WAL checkpoint racing
        # a commit), which surfaced as rare 500s under the event server's
        # concurrent posts; waiting is always the right call here
        conn.execute("PRAGMA busy_timeout=10000")
        self._ensure_schema_version(conn)
        return conn

    def _ensure_schema_version(self, conn: sqlite3.Connection) -> None:
        """Stamp/migrate the DB to SCHEMA_VERSION on open (idempotent;
        later connections of the same file see the stamp and return on
        the first check).  Concurrency: BEGIN IMMEDIATE serializes two
        processes opening the same legacy file — the version is
        re-read inside the write transaction, so the loser re-checks
        and finds the winner's stamp."""
        v = conn.execute("PRAGMA user_version").fetchone()[0]
        if v == SCHEMA_VERSION:
            return
        if v > SCHEMA_VERSION:
            raise RuntimeError(
                f"event DB {self._path!r} has schema v{v}, newer than "
                f"this framework's v{SCHEMA_VERSION} — refusing to "
                "open (upgrade predictionio_tpu instead)"
            )
        with self._lock:
            conn.execute("BEGIN IMMEDIATE")
            try:
                # re-read under the write lock: another process may have
                # migrated (or a NEWER framework stamped) while we
                # waited — never overwrite a stamp >= ours, and refuse
                # a newer one here too or the loser would DOWNGRADE it
                v = conn.execute("PRAGMA user_version").fetchone()[0]
                if v >= SCHEMA_VERSION:
                    conn.rollback()
                    if v > SCHEMA_VERSION:
                        raise RuntimeError(
                            f"event DB {self._path!r} has schema v{v}, "
                            f"newer than this framework's "
                            f"v{SCHEMA_VERSION} — refusing to open "
                            "(upgrade the framework instead)"
                        )
                    return
                while v < SCHEMA_VERSION:
                    mig = _MIGRATIONS.get(v)
                    if mig is None:
                        raise RuntimeError(
                            f"no migration path from event-DB schema "
                            f"v{v} to v{SCHEMA_VERSION}"
                        )
                    mig(conn)
                    v += 1
                conn.execute(f"PRAGMA user_version = {SCHEMA_VERSION}")
                conn.commit()
            except BaseException:
                conn.rollback()
                raise

    def schema_version(self) -> int:
        """The opened DB's stamped schema version (== SCHEMA_VERSION
        after a successful open)."""
        return int(
            self._conn.execute("PRAGMA user_version").fetchone()[0]
        )

    @property
    def _conn(self) -> "sqlite3.Connection | SerializedConnection":
        if self._shared:
            return self._conn_shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._connect()
            self._local.conn = conn
        return conn

    def _ensure_table(self, app_id: int, channel_id: int) -> str:
        t = _table_name(app_id, channel_id)
        if t not in self._known_tables:
            with self._lock:
                self._conn.executescript(_SCHEMA.format(table=t))
                self._conn.commit()
                self._known_tables.add(t)
        return t

    def _bump_version(self, t: str) -> None:
        """Monotonic per-table write counter, bumped INSIDE each write's
        transaction — the scan cache's change fingerprint.  (count,
        max rowid) alone is not change-proof: sqlite reuses the max rowid
        after its row is deleted, so a delete+insert pair could leave it
        unchanged and serve a stale snapshot.  A rolled-back bulk scope
        rolls its bump back too, keeping the counter consistent with the
        visible data.
        """
        self._conn.execute(
            "INSERT INTO _scan_versions VALUES (?, 1) "
            "ON CONFLICT(tbl) DO UPDATE SET v = v + 1",
            (t,),
        )

    def _version(self, t: str) -> int:
        row = self._conn.execute(
            "SELECT v FROM _scan_versions WHERE tbl=?", (t,)
        ).fetchone()
        return int(row[0]) if row else 0

    def _snapshot_fingerprint(self, t: str) -> tuple:
        """The scan cache's key for table ``t`` as it stands: the table's
        write version, the file's inode and the file's token, a random
        number written once into ``_scan_versions`` (under a name no
        events table can have) by the first cached scan of the file.
        Deleting and recreating the database resets the version counter
        and may reuse the inode, but draws a new token, so the old
        file's snapshots are never served for the new file's data.  A
        write to another table of the same file changes none of the
        three (the file's ctime, which it does change, is not part of
        the key).  Called outside any bulk scope: the token's insert
        commits on this thread's connection."""
        row = self._conn.execute(
            "SELECT v FROM _scan_versions WHERE tbl=?", (_TOKEN_ROW,)
        ).fetchone()
        if row is None:
            with self._lock:
                # another process may insert first: the loser's insert
                # is ignored and both read the winner's token back
                self._conn.execute(
                    "INSERT OR IGNORE INTO _scan_versions VALUES (?, ?)",
                    (_TOKEN_ROW, secrets.randbits(62)),
                )
                self._conn.commit()
            row = self._conn.execute(
                "SELECT v FROM _scan_versions WHERE tbl=?", (_TOKEN_ROW,)
            ).fetchone()
        return (self._version(t), os.stat(self._path).st_ino, int(row[0]))

    # -- lifecycle --------------------------------------------------------
    def init_channel(self, app_id: int, channel_id: int = 0) -> bool:
        self._ensure_table(app_id, channel_id)
        return True

    def remove_channel(self, app_id: int, channel_id: int = 0) -> bool:
        t = _table_name(app_id, channel_id)
        with self._lock:
            self._conn.execute(f"DROP TABLE IF EXISTS {t}")
            # the version table may not exist yet on a store that never
            # ensured any event table; removal must still bump (cached
            # scans of the dropped table die with it)
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS _scan_versions "
                "(tbl TEXT PRIMARY KEY, v INTEGER NOT NULL)"
            )
            self._bump_version(t)
            self._conn.commit()
            self._known_tables.discard(t)
        return True

    def close(self) -> None:
        with self._lock:
            if self._shared:
                self._conn_shared.close()
            else:
                conn = getattr(self._local, "conn", None)
                if conn is not None:
                    conn.close()
                    self._local.conn = None

    def compact(self) -> None:
        """VACUUM + WAL truncate: rebuild the DB without the pages
        deletes freed (`app trim` leaves them allocated) and fold the
        rewrite back into the main file — in WAL mode VACUUM's result
        lives in the -wal until a checkpoint, so without TRUNCATE the
        on-disk footprint would not shrink at all.  Must run outside
        any transaction and takes the writer lock for its duration —
        an offline-maintenance operation, not a serving-path one."""
        with self._lock:
            conn = self._conn
            conn.commit()  # VACUUM refuses inside a transaction
            conn.execute("VACUUM")
            conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            conn.commit()

    # -- writes -----------------------------------------------------------
    def _row(self, event: Event, eid: str) -> tuple:
        return event_to_row(event, eid)

    def insert(self, event: Event, app_id: int, channel_id: int = 0,
               validate: bool = True) -> str:
        # the storage boundary honors a caller's propagated time budget
        # (resilience/policy.Deadline): no-op unless a scope is active
        check_deadline("event store write")
        if validate:
            validate_event(event)
        t = self._ensure_table(app_id, channel_id)
        eid = event.event_id or new_event_id()
        with self._lock:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                self._row(event, eid),
            )
            self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()
        return eid

    def insert_batch(
        self, events, app_id: int, channel_id: int = 0,
        validate: bool = True,
    ) -> list[str]:
        t = self._ensure_table(app_id, channel_id)
        events = list(events)
        fresh = iter(new_event_ids(len(events)))
        rows, ids = [], []
        for e in events:
            if validate:
                validate_event(e)
            eid = e.event_id or next(fresh)
            ids.append(eid)
            rows.append(self._row(e, eid))
        with self._lock:
            if self._bulk_depth:
                self._maybe_defer_indexes(t)
            self._conn.executemany(
                f"INSERT OR REPLACE INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows
            )
            self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()
        return ids

    def insert_raw_rows(self, rows, app_id: int, channel_id: int = 0) -> None:
        """Low-level bulk insert of pre-built storage rows.

        The native importer fast path (`tools/import_export.py` +
        `native/jsonl_scan.cpp`) and the ingest WAL's drain hand over
        row fields without constructing Event objects; each row must
        match the 11-column events schema of :meth:`_row` exactly and be
        pre-validated.  Not part of the EventStore contract: callers
        feature-test with ``hasattr``.
        """
        t = self._ensure_table(app_id, channel_id)
        rows = rows if isinstance(rows, list) else list(rows)
        with self._lock:
            if self._bulk_depth:
                self._maybe_defer_indexes(t)
            # _ROWS_PER_INSERT rows a statement, in order: the rows and
            # rowids of executemany, with one statement step for
            # _ROWS_PER_INSERT rows instead of one a row
            full = _multi_insert(t, _ROWS_PER_INSERT)
            for a in range(0, len(rows), _ROWS_PER_INSERT):
                part = rows[a:a + _ROWS_PER_INSERT]
                self._conn.execute(
                    full if len(part) == _ROWS_PER_INSERT
                    else _multi_insert(t, len(part)),
                    list(itertools.chain.from_iterable(part)),
                )
            self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()

    def purge_older_than(self, cutoff_millis: int, app_id: int,
                         channel_id: int = 0) -> int:
        """TTL enforcement for the live ingest window: delete rows whose
        EVENT time predates ``cutoff_millis`` and return the count.

        Event time, not creation time — the window the trending
        re-scans and fold-in deltas reason in.  Watermark cursors stay
        valid: a purge below the cursor is invisible to the scan, and a
        cursor below the purge floor simply finds fewer rows — stale
        events it would have folded in are gone, which is the TTL's
        contract.  (sqlite only ever reuses a freed MAX rowid, and only
        when the newest-INSERTED row carries the oldest EVENT time —
        live ingest never does that; bulk historical imports should
        purge before cursors are cut.)  Not part of the EventStore ABC
        — callers feature-test with ``hasattr``.
        """
        t = self._ensure_table(app_id, channel_id)
        with self._lock:
            cur = self._conn.execute(
                f"DELETE FROM {t} WHERE event_time < ?",
                (int(cutoff_millis),),
            )
            n = cur.rowcount if cur.rowcount and cur.rowcount > 0 else 0
            if n:
                self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()
        return n

    def iter_raw_rows(self, app_id: int, channel_id: int = 0):
        """Yield raw 11-column storage rows (schema of :meth:`_row`).

        The exporter fast path: composing wire JSON straight from stored
        parts skips Event construction + re-serialization.  Not part of
        the EventStore contract — callers feature-test with ``hasattr``.
        """
        t = self._ensure_table(app_id, channel_id)
        # same ordering as find(): exports stay time-sorted
        cur = self._conn.execute(
            f"SELECT * FROM {t} ORDER BY event_time, event_id"
        )
        while True:
            rows = cur.fetchmany(10_000)
            if not rows:
                return
            yield from rows

    @property
    def _bulk_depth(self) -> int:
        return getattr(self._local, "bulk_depth", 0)

    # bulk writes into a table at or below this row count drop the
    # secondary indexes and rebuild once at commit; above it, the table
    # is big enough that a full rebuild would cost more than the
    # incremental maintenance of a (presumed small) append
    _DEFER_MAX_EXISTING_ROWS = 100_000

    def _maybe_defer_indexes(self, t: str) -> None:
        """Called under the lock from bulk-scope write paths: drop the
        table's secondary indexes for the duration of the scope when
        the table is small (fresh imports — the certified 20M path —
        have zero existing rows).  Big tables keep their indexes: a
        10k-event append to a 20M-row table must not trigger a full
        three-index rebuild at commit."""
        if not getattr(self._local, "bulk_defer", True):
            return
        if t in self._local.bulk_dropped or t in self._local.bulk_kept:
            return
        # existence probe at O(threshold), NOT COUNT(*): a full count
        # scans the whole table — worst exactly on the big tables this
        # check protects
        big = self._conn.execute(
            f"SELECT 1 FROM {t} LIMIT 1 OFFSET {self._DEFER_MAX_EXISTING_ROWS}"
        ).fetchone()
        if big:
            self._local.bulk_kept.add(t)
            return
        # python sqlite3 implicitly BEGINs only for DML, not DDL — the
        # drops must join the scope's transaction or a rollback would
        # restore the rows but leave the indexes gone
        conn = self._conn
        raw = getattr(conn, "_conn", conn)  # SerializedConnection proxy
        if not raw.in_transaction:
            conn.execute("BEGIN")
        for name in _INDEX_NAMES:
            conn.execute(f"DROP INDEX IF EXISTS {name.format(t=t)}")
        self._local.bulk_dropped.add(t)

    @contextlib.contextmanager
    def bulk(self, defer_indexes: bool = True):
        """Defer commits to the end of the scope: bulk imports pay one
        fsync instead of one per 5k-event batch.

        Scoped to the CALLING THREAD: connections are thread-local, so a
        store-wide flag would make a concurrent writer on another thread
        skip the commit its own connection needs (rows stuck invisible in
        an open transaction).  Other threads' writes keep their normal
        commit-per-call behavior while a bulk scope is active here.

        The outermost scope holds the store's writer lock from its start
        to its commit or rollback.  The scope's sqlite write transaction
        is open that whole time, so a writer on another thread could not
        write before the commit anyway; holding the lock makes it wait
        for the lock instead of waiting inside sqlite while holding the
        lock that the commit needs (the two stalled each other for the
        10 s busy timeout, and the single write then failed with
        "database is locked").  Readers never take the lock: a long
        import does not block them.

        A failed scope ROLLS BACK instead of committing: the single
        transaction makes a crashed import atomic — no half-persisted
        file with no marker of how far it got.  Every write path on this
        thread (insert/insert_batch/delete/delete_batch) defers its
        commit inside the scope.  Caveats: creating a NEW (app, channel)
        table mid-scope runs DDL, which sqlite auto-commits — call
        ``init_channel`` before the scope for strict atomicity (the bulk
        importer does); and the shared-connection ``:memory:`` mode can
        have another thread's commit absorb pending rows (test-only
        backend, single-writer assumption).

        Index deferral (``defer_indexes=True``, the importer default):
        the first bulk write to a SMALL table (see
        ``_maybe_defer_indexes``) drops its secondary indexes inside
        the open transaction and rebuilds them wholesale just before
        the commit — incremental B-tree maintenance on random entity
        keys was 62% of import wall time at ML-20M scale (profiled;
        BENCH_FULLSCALE_CPU.json import stage), while a post-load
        rebuild is one sort per index.  A rollback restores the
        indexes with everything else (sqlite DDL is transactional).
        Pass ``defer_indexes=False`` for SHORT atomicity scopes (e.g.
        the sharded store wrapping one request's groups): rebuilding
        whole-table indexes per 50-event request would be quadratic
        steady-state ingest.  The flag is consulted only when THIS
        call opens the outermost scope; nested scopes inherit it.
        """
        if self._bulk_depth:
            yield from self._bulk_scope(False, defer_indexes)
            return
        self._lock.acquire()
        try:
            yield from self._bulk_scope(True, defer_indexes)
        finally:
            self._lock.release()

    def _bulk_scope(self, outer: bool, defer_indexes: bool):
        """The scope of :meth:`bulk`, which delegates to this generator
        (the outermost scope with the writer lock held): the thread's
        scope state, the yield, then the commit or the rollback."""
        self._local.bulk_depth = self._bulk_depth + 1
        if outer:
            self._local.bulk_dropped = set()
            self._local.bulk_kept = set()
            self._local.bulk_defer = defer_indexes
        try:
            yield self
        except BaseException:
            self._local.bulk_depth -= 1
            if outer:
                self._conn.rollback()
                # normally the rollback restores the dropped indexes,
                # but interleaved DDL (_ensure_table for a NEW
                # app/channel) implicitly COMMITs mid-scope, making the
                # drop durable — rebuild idempotently (IF NOT EXISTS: a
                # no-op when rollback sufficed) so a failed import can't
                # strand an index-less table across restarts
                self._rebuild_dropped_indexes()
                self._conn.commit()
            raise
        else:
            self._local.bulk_depth -= 1
            if outer:
                self._rebuild_dropped_indexes()
                self._conn.commit()

    def _rebuild_dropped_indexes(self) -> None:
        """Recreate (IF NOT EXISTS) the secondary indexes of every
        table this thread's bulk scope dropped; called under the
        lock."""
        for t in self._local.bulk_dropped:
            # a remove_channel inside the scope may have dropped the
            # table out from under its indexes
            if not self._conn.execute(
                "SELECT 1 FROM sqlite_master "
                "WHERE type='table' AND name=?", (t,)
            ).fetchone():
                continue
            for stmt in _INDEX_SQL:
                self._conn.execute(stmt.format(t=t))
        self._local.bulk_dropped = set()

    # -- point reads ------------------------------------------------------
    @staticmethod
    def _event_from_row(r: tuple) -> Event:
        return Event(
            event_id=r[0],
            event=r[1],
            entity_type=r[2],
            entity_id=r[3],
            target_entity_type=r[4],
            target_entity_id=r[5],
            properties=DataMap(json.loads(r[6])),
            event_time=from_millis(r[7]),
            tags=tuple(json.loads(r[8])),
            pr_id=r[9],
            creation_time=from_millis(r[10]),
        )

    def get(self, event_id: str, app_id: int, channel_id: int = 0) -> Optional[Event]:
        t = self._ensure_table(app_id, channel_id)
        cur = self._conn.execute(f"SELECT * FROM {t} WHERE event_id=?", (event_id,))
        row = cur.fetchone()
        return self._event_from_row(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: int = 0) -> bool:
        t = self._ensure_table(app_id, channel_id)
        with self._lock:
            cur = self._conn.execute(
                f"DELETE FROM {t} WHERE event_id=?", (event_id,)
            )
            self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()
            return cur.rowcount > 0

    def delete_batch(self, event_ids, app_id: int, channel_id: int = 0) -> int:
        t = self._ensure_table(app_id, channel_id)
        ids = [(eid,) for eid in event_ids]
        if not ids:
            return 0
        with self._lock:
            cur = self._conn.executemany(
                f"DELETE FROM {t} WHERE event_id=?", ids
            )
            removed = cur.rowcount if cur.rowcount >= 0 else len(ids)
            # a no-op delete must not invalidate cached scans (sharded
            # stores fan every id to every shard; only the shard that
            # actually held rows has a changed table)
            if removed:
                self._bump_version(t)
            if not self._bulk_depth:
                self._conn.commit()
            return removed

    # -- scans ------------------------------------------------------------
    def _query(
        self,
        table: str,
        start_time,
        until_time,
        entity_type,
        entity_id,
        event_names,
        target_entity_type: TargetFilter,
        target_entity_id: TargetFilter,
        limit,
        reversed: bool,
        columns: str = "*",
    ) -> tuple[str, list]:
        where, params = [], []
        if start_time is not None:
            where.append("event_time >= ?")
            params.append(time_millis(start_time))
        if until_time is not None:
            where.append("event_time < ?")
            params.append(time_millis(until_time))
        if entity_type is not None:
            where.append("entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            where.append("entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            qs = ",".join("?" * len(event_names))
            where.append(f"event IN ({qs})")
            params.extend(event_names)
        for col, filt in (
            ("target_entity_type", target_entity_type),
            ("target_entity_id", target_entity_id),
        ):
            if filt is None:
                continue
            if filt is NO_TARGET:
                where.append(f"{col} IS NULL")
            else:
                where.append(f"{col} = ?")
                params.append(filt)
        sql = f"SELECT {columns} FROM {table}"
        if where:
            sql += " WHERE " + " AND ".join(where)
        sql += f" ORDER BY event_time {'DESC' if reversed else 'ASC'}, event_id"
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        return sql, params

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
        check_deadline("event store scan")
        t = self._ensure_table(app_id, channel_id)
        sql, params = self._query(
            t, start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, limit, reversed,
        )
        cur = self._conn.execute(sql, params)
        return (self._event_from_row(r) for r in iter(cur.fetchone, None))

    # -- fused training read (scan + encode in C) -------------------------
    def find_ratings(
        self,
        app_id: int,
        channel_id: int = 0,
        event_names: Sequence[str] = ("rate",),
        rating_property: Optional[str] = "rating",
        dedup: str = "last",
        entity_type: Optional[str] = None,
        cache: Optional[bool] = None,
    ) -> Ratings:
        """COO :class:`~predictionio_tpu_torch.storage.columnar.Ratings`
        straight from the events table in one native pass
        (``native/sqlite_scan.cpp``: the sqlite scan and the string-id
        dictionary build fused).  ``rating_property=None`` is the
        implicit-feedback read (every event counts 1.0).

        The Python branch, exactly ``find_columnar(minimal=True) ->
        to_ratings``, runs only where the reference's does for a reason
        of the data or the store: an in-memory db, an open bulk scope
        (uncommitted rows live on this thread's connection), no event
        names, a property name that is not ``[A-Za-z0-9_]+``, or a scan
        that sqlite fails (``json_extract`` on a NaN or Infinity token).
        A failed native build raises.  The branch taken is kept in
        ``last_ratings_scan_path`` (``"native"``, ``"python"`` or
        ``"cache"``) and the Python branch's reason in
        ``last_ratings_scan_reason``.

        Encoding matches ``to_ratings``' sorted-unique determinism: the
        native first-seen codes are remapped through one argsort of the
        (small) unique-id table.  Dedup shares ``dedup_coo`` with the
        Python branch.
        """
        from ..native import NativeScanError, scan_ratings_sqlite
        from . import scan_cache
        from .bimap import StringIndex
        from .columnar import dedup_coo

        event_names = list(event_names)
        # same snapshot cache as find_columnar, at the RATINGS level:
        # repeat trains skip the scan and the encode
        cache_key = None
        v_before = None
        if (
            scan_cache.enabled(cache)
            and self._path != ":memory:"
            and self._bulk_depth == 0
        ):
            t0 = self._ensure_table(app_id, channel_id)
            fingerprint = self._snapshot_fingerprint(t0)
            v_before = fingerprint[0]
            cache_key = scan_cache.key(
                self._path, t0, fingerprint,
                ["find_ratings", event_names, rating_property, dedup,
                 entity_type],
            )
            cached = scan_cache.load_ratings(cache_key)
            if cached is not None:
                self.last_ratings_scan_path = "cache"
                self.last_ratings_scan_reason = None
                return cached

        if self._path == ":memory:":
            reason = "in-memory db"
        elif self._bulk_depth:
            reason = "open bulk scope"
        elif not event_names:
            reason = "no event names"
        elif rating_property is not None and not re.fullmatch(
                r"[A-Za-z0-9_]+", rating_property):
            reason = f"property name {rating_property!r}"
        else:
            reason = None
        native = None
        if reason is None:
            t = self._ensure_table(app_id, channel_id)
            # same WHERE semantics as the Python branch's _query: event
            # names and entity_type are VALUES (bound); the table name
            # and the validated property name are identifiers
            value_sql = (
                f", json_extract(properties, '$.{rating_property}')"
                if rating_property is not None else ""
            )
            qs = ",".join("?" * len(event_names))
            sql = (
                f"SELECT entity_id, target_entity_id, event_time"
                f"{value_sql} FROM {t} WHERE event IN ({qs})"
            )
            binds = list(event_names)
            if entity_type is not None:
                sql += f" AND entity_type = ?{len(binds) + 1}"
                binds.append(entity_type)
            try:
                native = scan_ratings_sqlite(
                    self._path, sql, binds,
                    has_value_col=rating_property is not None,
                )
            except NativeScanError as e:
                reason = f"sqlite scan error: {e}"
                logger.warning(
                    "native ratings scan fell back to python: %s", e
                )
        if native is None:
            self.last_ratings_scan_path = "python"
            self.last_ratings_scan_reason = reason
            # cache=False: the result is cached at the RATINGS level
            # below; a frame snapshot would never be read back
            frame = self.find_columnar(
                app_id, channel_id, event_names=event_names,
                float_property=rating_property, minimal=True,
                entity_type=entity_type, cache=False,
            )
            out = frame.to_ratings(
                rating_property=rating_property, dedup=dedup
            )
            return self._maybe_store_ratings(
                out, cache_key, v_before, app_id, channel_id
            )
        self.last_ratings_scan_path = "native"
        self.last_ratings_scan_reason = None

        u, i, v, t_ms, user_ids, item_ids = native
        # first-seen -> sorted-unique codes (to_ratings determinism)
        uo = np.argsort(user_ids)
        io = np.argsort(item_ids)
        urank = np.empty(len(uo), np.int32)
        urank[uo] = np.arange(len(uo), dtype=np.int32)
        irank = np.empty(len(io), np.int32)
        irank[io] = np.arange(len(io), dtype=np.int32)
        u = urank[u] if len(u) else u
        i = irank[i] if len(i) else i
        ok = ~np.isnan(v)
        u, i, v, t_ms = u[ok], i[ok], v[ok], t_ms[ok]
        u, i, v = dedup_coo(u, i, v, t_ms, len(item_ids), dedup)
        out = Ratings(
            user_ix=u.astype(np.int32),
            item_ix=i.astype(np.int32),
            rating=v.astype(np.float32),
            users=StringIndex(user_ids[uo]),
            items=StringIndex(item_ids[io]),
        )
        return self._maybe_store_ratings(
            out, cache_key, v_before, app_id, channel_id
        )

    def _maybe_store_ratings(self, out, cache_key, v_before, app_id,
                             channel_id):
        """One store gate for both find_ratings branches: snapshot only
        when the table is provably unchanged across the scan (the same
        rule as find_columnar's frame snapshots)."""
        from . import scan_cache

        if (
            cache_key is not None
            and self._version(self._ensure_table(app_id, channel_id))
            == v_before
        ):
            scan_cache.store_ratings(cache_key, out)
        return out

    # -- incremental scans (pio-live watermark cursor) --------------------
    def max_rowid(self, app_id: int, channel_id: int = 0) -> int:
        """Largest rowid of the (app, channel) table (0 when empty): the
        event store's high-water mark.  ``MAX(rowid)`` is answered off
        the table B-tree root, not a scan."""
        t = self._ensure_table(app_id, channel_id)
        row = self._conn.execute(f"SELECT MAX(rowid) FROM {t}").fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    def high_water_cursor(self, app_id: int, channel_id: int = 0) -> int:
        """The cursor at the current high-water mark (same shape the
        sharded store exposes; here a cursor IS a rowid)."""
        return self.max_rowid(app_id, channel_id)

    def cursor_lag(self, app_id: int, channel_id: int = 0,
                   cursor: int = 0) -> int:
        """Rows written past ``cursor`` — the freshness debt the
        watermark gauges report (the sharded store sums per shard)."""
        return max(self.max_rowid(app_id, channel_id) - int(cursor), 0)

    def find_rows_since(
        self,
        app_id: int,
        channel_id: int = 0,
        cursor: int = 0,
        limit: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        newest_first: bool = False,
    ) -> tuple[list[tuple], int]:
        """Raw rows written after a rowid watermark, in insertion order.

        Returns ``(rows, new_cursor)`` where each row is ``(rowid,
        <the 11 storage columns of _row>)`` with ``rowid > cursor``,
        rowid-ascending, and ``new_cursor`` is the largest rowid
        returned (== ``cursor`` when nothing is new).  The rowid is the
        table's B-tree key, so this is an INDEXED range scan — the
        incremental primitive the pio-live fold-in watermark and the
        dashboard's recent-events view share, instead of re-scanning
        the whole table per poll.

        Semantics callers rely on:

        * rowids are assigned monotonically by sqlite while the table's
          max row is never deleted; ``INSERT OR REPLACE`` of an
          existing event_id assigns a FRESH rowid, so updated events
          re-enter the scan window (a fold-in wants exactly that).
        * ``limit`` bounds one page; advancing ``cursor`` to the
          returned ``new_cursor`` and calling again pages through a
          backlog without skipping or repeating rows.
        * ``newest_first=True`` reverses the order (dashboard view);
          the cursor contract is unchanged (``new_cursor`` is still the
          max rowid seen).
        """
        t = self._ensure_table(app_id, channel_id)
        where = ["rowid > ?"]
        params: list = [int(cursor)]
        if event_names is not None:
            qs = ",".join("?" * len(event_names))
            # "+event": no index on this term, so sqlite walks the rowid
            # range; with it, the (event, event_time) index wins and the
            # scan reads every row of the named events, then sorts
            where.append(f"+event IN ({qs})")
            params.extend(event_names)
        sql = (
            f"SELECT rowid, * FROM {t} WHERE {' AND '.join(where)} "
            f"ORDER BY rowid {'DESC' if newest_first else 'ASC'}"
        )
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        rows = self._conn.execute(sql, params).fetchall()
        new_cursor = int(cursor)
        if rows:
            new_cursor = max(int(r[0]) for r in rows)
        return rows, new_cursor

    def find_since(
        self,
        app_id: int,
        channel_id: int = 0,
        cursor: int = 0,
        limit: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        newest_first: bool = False,
    ) -> tuple[list[tuple[int, Event]], int]:
        """:meth:`find_rows_since` decoded to ``(rowid, Event)`` pairs."""
        rows, new_cursor = self.find_rows_since(
            app_id, channel_id, cursor, limit, event_names, newest_first
        )
        return (
            [(int(r[0]), self._event_from_row(r[1:])) for r in rows],
            new_cursor,
        )

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
        float_default: float = np.nan,
        minimal: bool = False,
        cache: Optional[bool] = None,
    ) -> EventFrame:
        """Bulk scan straight into column arrays.

        When ``float_property`` is given, that property is extracted per
        event into a float64 column (missing -> ``float_default``) by
        sqlite's built-in JSON1 ``json_extract`` — no per-row Python JSON
        parsing.  ``minimal=True`` additionally narrows the SELECT to the
        columns the rating/training hot path consumes (entity_id,
        target_entity_id, event_time, value): at ML-20M scale the scan
        cost is Python-object creation in the sqlite cursor, so 3 columns
        instead of 7 is ~2x (the other EventFrame fields come back
        ``None``; ``to_ratings``/``select`` handle that).

        ``cache`` (default: env ``PIO_TPU_SCAN_CACHE=1``) snapshots the
        result to an npz keyed by the table's write-version counter (see
        :meth:`_bump_version`) plus the database file's identity, so
        repeat trains on an unchanged table read back at numpy speed
        instead of re-paying the cursor scan (scan_cache.py).
        """
        t = self._ensure_table(app_id, channel_id)
        from . import scan_cache

        cache_key = None
        v_before = None
        # no caching inside a bulk() scope: uncommitted rows must never be
        # published, and a rollback would strand the snapshot
        if (
            scan_cache.enabled(cache)
            and self._path != ":memory:"
            and self._bulk_depth == 0
        ):
            fingerprint = self._snapshot_fingerprint(t)
            v_before = fingerprint[0]
            cache_key = scan_cache.key(
                self._path, t, fingerprint,
                [
                    str(start_time), str(until_time), entity_type,
                    entity_id, event_names, target_entity_type,
                    target_entity_id, float_property, float_default,
                    minimal,
                ],
            )
            cached = scan_cache.load(cache_key)
            if cached is not None:
                return cached
        # json_extract path syntax can't express arbitrary key names
        # safely; only simple names take the SQL fast path.  NOTE: rows
        # whose properties blob holds NaN/Infinity tokens (json.dumps
        # emits them; strict JSON forbids them) make json_extract raise —
        # _scan_columns retries those scans with extract_in_sql=False.
        simple_prop = bool(
            float_property is not None
            and re.fullmatch(r"[A-Za-z0-9_]+", float_property)
        )
        try:
            cols_t, n = self._scan_columns(
                t, minimal, float_property, simple_prop,
                (start_time, until_time, entity_type, entity_id,
                 event_names, target_entity_type, target_entity_id),
            )
            extracted = simple_prop
        except sqlite3.OperationalError as e:
            if not simple_prop or "JSON" not in str(e).upper():
                raise
            cols_t, n = self._scan_columns(
                t, minimal, float_property, False,
                (start_time, until_time, entity_type, entity_id,
                 event_names, target_entity_type, target_entity_id),
            )
            extracted = False

        def obj(col):
            a = np.empty(n, dtype=object)
            if n:
                a[:] = col
            return a

        def i64(col):
            return (np.asarray(col, dtype=np.int64) if n
                    else np.empty(0, np.int64))

        def floats(col):
            # col holds json_extract results: numbers or None
            out = np.full(n, float_default, dtype=np.float64)
            for i, v in enumerate(col):
                if v is not None:
                    out[i] = float(v)
            return out

        def peek(col):
            # col holds raw properties blobs: python-side JSON peek
            out = np.full(n, float_default, dtype=np.float64)
            for i, blob in enumerate(col):
                if blob != "{}":
                    v = json.loads(blob).get(float_property)
                    if v is not None:
                        out[i] = float(v)
            return out

        values = props = None
        if float_property is not None:
            vcol = cols_t[-1]           # value/properties is always last
            values = floats(vcol) if extracted else peek(vcol)
        elif not minimal:
            props = obj([json.loads(b) for b in cols_t[-1]])

        if minimal:
            frame = EventFrame(
                event=None,
                entity_type=None,
                entity_id=obj(cols_t[0]),
                target_entity_type=None,
                target_entity_id=obj(cols_t[1]),
                event_time_ms=i64(cols_t[2]),
                properties=None,
                value=values,
            )
        else:
            frame = EventFrame(
                event=obj(cols_t[0]),
                entity_type=obj(cols_t[1]),
                entity_id=obj(cols_t[2]),
                target_entity_type=obj(cols_t[3]),
                target_entity_id=obj(cols_t[4]),
                event_time_ms=i64(cols_t[5]),
                properties=props,
                value=values,
            )
        if cache_key is not None and self._version(t) == v_before:
            # store only when no write landed during the scan: the
            # fingerprint then provably describes the snapshot's contents
            scan_cache.store(cache_key, frame)
        return frame

    def _scan_columns(self, t, minimal, float_property, extract_in_sql,
                      filters):
        """Run the columnar SELECT; returns (columns, n).

        The SELECT is built as a list so positions are structural, and the
        value/properties expression — when present — is always LAST.
        """
        (start_time, until_time, entity_type, entity_id, event_names,
         target_entity_type, target_entity_id) = filters
        sel = (
            ["entity_id", "target_entity_id", "event_time"] if minimal
            else ["event", "entity_type", "entity_id",
                  "target_entity_type", "target_entity_id", "event_time"]
        )
        if float_property is not None:
            sel.append("json_extract(properties, ?)" if extract_in_sql
                       else "properties")
        elif not minimal:
            sel.append("properties")
        sql, params = self._query(
            t, start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, None, False,
            columns=", ".join(sel),
        )
        if extract_in_sql:
            # SELECT placeholders precede WHERE placeholders positionally
            params = [f'$."{float_property}"'] + list(params)
        rows = self._conn.execute(sql, params).fetchall()
        cols_t = list(zip(*rows)) if rows else [()] * len(sel)
        return cols_t, len(rows)
