"""Entity-hash-sharded SQLite event store: region-parallel writes.

Port of ``predictionio_tpu/storage/sharded_events.py``, with the same
routing, file layout and marker, so a sharded store written by either
package is read by the other.

The reference's HBase event table is written region-parallel — its
bulk write path partitions by the md5-prefixed rowkey and each region
server commits independently
(`data/.../storage/hbase/HBPEvents.scala:180-199`, rowkey design
`HBEventsUtil.scala:74-129`).  The single-file SQLite store serializes
every write behind ONE writer lock + WAL.  This store shards the event
table by a stable entity hash across N SQLite files: N independent
writer locks and WAL commits, so concurrent writers (shard-owner event
servers behind the ingest router) scale with shard count.

Reads compose: entity-scoped queries route to exactly one shard (the
rowkey-prefix locality property); full scans merge the per-shard
time-ordered streams (``heapq.merge``) or concatenate columnar frames;
the training read (:meth:`ShardedSQLiteEventStore.find_ratings`) scans
every shard at once, one native scan per shard on its own thread.

Routing is ``crc32(entity_type ++ entity_id) % n_shards`` — stable
across processes and runs (NOT python ``hash()``, which is salted per
process).  The shard count is fixed at creation and stamped in a marker
file; opening with a different count refuses loudly instead of silently
mis-routing entities.

Known semantic drift from the single-file store: re-inserting an
EXPLICIT ``event_id`` under a different entity lands in a different
shard, so the cross-file OR-REPLACE upsert cannot collapse the two rows
— both remain until deleted (``delete`` removes every copy).
Auto-generated ids are unique, so only clients that reuse ids across
entities can observe this; the reference's HBase rowkeys (entity-hash
prefixed) cannot express that operation at all.

The JSON-lines import of a large file
(:meth:`ShardedSQLiteEventStore.import_shard_files`) writes each shard
file from a worker process of its own, in file order
(``tools/shard_import.py``); every other write runs on the calling
thread.

The incremental scans (``find_rows_since``, ``find_since``,
``max_rowid``, ``high_water_cursor``, ``cursor_lag``) page each shard
past its own rowid; their cursor is the JSON shard vector the fold-in
(``live/``) carries opaquely.

Writes and scans book the reference's per-shard ``obs`` families
(``pio_store_shard_write_seconds``, ``pio_store_shard_scan_seconds``,
``pio_store_shard_rows``) and consult the ``store.shard_down`` fault
point.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import heapq
import itertools
import json
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ..obs import (
    STORE_SHARD_ROWS,
    STORE_SHARD_SCAN_SECONDS,
    STORE_SHARD_WRITE_SECONDS,
)
from ..resilience import faults
from .columnar import EventFrame, Ratings
from .event import Event, validate_event
from .levents import EventStore, ShardUnavailableError, TargetFilter
from .sqlite_events import SQLiteEventStore

__all__ = ["ShardedSQLiteEventStore"]

_MARKER = "shards.json"


def _shard_ix(entity_type: str, entity_id: str, n: int) -> int:
    h = zlib.crc32(
        f"{entity_type}\x00{entity_id}".encode("utf-8", "surrogatepass")
    )
    return h % n


class ShardedSQLiteEventStore(EventStore):
    """N SQLite event stores under one directory, routed by entity hash.

    ``path`` is a DIRECTORY (created if absent) holding
    ``shard-<i>.db`` files plus a ``shards.json`` marker recording the
    count.  The registry builds it for the ``sqlite-sharded`` source type
    (PATH, SHARDS).
    """

    def __init__(self, path: str | Path, n_shards: int = 4):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self._dir = Path(path)
        self._dir.mkdir(parents=True, exist_ok=True)
        marker = self._dir / _MARKER
        try:
            # atomic create: two first-time opens racing with DIFFERENT
            # shard counts must not both succeed (each would route the
            # same entity to a different file) — exactly one writes the
            # marker, the loser falls through to the compare
            with open(marker, "x") as f:
                f.write(json.dumps({"n_shards": n_shards}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except FileExistsError:
            # the winner may still be between create and write; wait
            # for content rather than crash on an empty read
            txt = ""
            for _ in range(200):
                txt = marker.read_text()
                if txt.strip():
                    break
                time.sleep(0.01)
            else:
                raise ValueError(
                    f"shard marker {marker} exists but never gained "
                    "content (crashed concurrent creator?); remove it "
                    "to re-initialize"
                )
            stamped = json.loads(txt).get("n_shards")
            if stamped != n_shards:
                raise ValueError(
                    f"event store at {self._dir} was created with "
                    f"{stamped} shards; opening with {n_shards} would "
                    "mis-route every entity — refusing"
                )
        self.n_shards = n_shards
        # each shard's writer lock is named, so one hot shard's
        # contention is attributable on pio_lock_wait_seconds{lock=}
        self.shards = [
            SQLiteEventStore(self._dir / f"shard-{i}.db",
                             lock_name=f"store_shard_{i}")
            for i in range(n_shards)
        ]
        # per-shard instrumentation, children resolved once (labels()
        # is too hot for the write path).  The row gauge tracks THIS
        # process's write-minus-delete delta: the ingestion-skew
        # signal, not a table count.
        self._m_write = [
            STORE_SHARD_WRITE_SECONDS.labels(shard=str(i))
            for i in range(n_shards)
        ]
        self._m_scan = [
            STORE_SHARD_SCAN_SECONDS.labels(shard=str(i))
            for i in range(n_shards)
        ]
        self._m_rows = [
            STORE_SHARD_ROWS.labels(shard=str(i)) for i in range(n_shards)
        ]
        # what the last find_ratings did: each shard's own seconds (its
        # scan and encode, on its thread) and the dictionary merge's
        self.last_ratings_shard_seconds: list[float] = []
        self.last_ratings_merge_seconds: Optional[float] = None

    # a shard-owner worker process restricts this to its fixed subset
    # post-construction; None = every shard (the single-process
    # default).  Ownership gates WRITES only — sqlite files accept
    # cross-process READERS safely, and scans must see the whole
    # keyspace regardless of who owns the writer lock.
    owned_shards: Optional[frozenset[int]] = None

    def set_owned_shards(self, shards: Optional[Iterable[int]]) -> None:
        if shards is None:
            self.owned_shards = None
            return
        owned = frozenset(int(s) for s in shards)
        bad = sorted(s for s in owned if not 0 <= s < self.n_shards)
        if bad:
            raise ValueError(
                f"owned shards {bad} out of range for "
                f"{self.n_shards}-shard store"
            )
        self.owned_shards = owned

    # -- routing ----------------------------------------------------------
    def _shard(self, entity_type: str, entity_id: str) -> SQLiteEventStore:
        return self.shards[_shard_ix(entity_type, entity_id,
                                     self.n_shards)]

    def shard_of(self, entity_type: str, entity_id: str) -> int:
        """The shard index an entity routes to — the routing table the
        ingest router shares with the store."""
        return _shard_ix(entity_type, entity_id, self.n_shards)

    def _check_writable(self, six: int) -> None:
        if self.owned_shards is not None and six not in self.owned_shards:
            raise ShardUnavailableError(
                six,
                "shard is not owned by this worker (router misroute or "
                "stale routing table)",
            )
        self._check_shard_up(six)

    def _check_shard_up(self, six: int) -> None:
        """``store.shard_down`` consultation (shard-scoped, see
        `resilience.faults.check_shard`); any injected error surfaces
        as the sticky `ShardUnavailableError`, never a transient."""
        try:
            faults.check_shard("store.shard_down", six)
        except ShardUnavailableError:
            raise
        except BaseException as e:
            raise ShardUnavailableError(six, str(e)) from e

    def _owned(self) -> list[SQLiteEventStore]:
        """The shards this process may write (maintenance scope: VACUUM
        and the TTL purge take the writer lock, which belongs to the
        owning worker in a fleet)."""
        return [s for i, s in enumerate(self.shards)
                if self.owned_shards is None or i in self.owned_shards]

    # -- lifecycle --------------------------------------------------------
    def init_channel(self, app_id: int, channel_id: int = 0) -> bool:
        for s in self.shards:
            s.init_channel(app_id, channel_id)
        return True

    def remove_channel(self, app_id: int, channel_id: int = 0) -> bool:
        ok = True
        for s in self.shards:
            ok = s.remove_channel(app_id, channel_id) and ok
        return ok

    def close(self) -> None:
        for s in self.shards:
            s.close()

    def compact(self) -> None:
        for s in self._owned():
            s.compact()

    # -- writes -----------------------------------------------------------
    def insert(self, event: Event, app_id: int, channel_id: int = 0,
               validate: bool = True) -> str:
        six = _shard_ix(event.entity_type, event.entity_id, self.n_shards)
        self._check_writable(six)
        t0 = time.perf_counter()
        eid = self.shards[six].insert(
            event, app_id, channel_id, validate=validate
        )
        self._m_write[six].observe(time.perf_counter() - t0)
        self._m_rows[six].inc()
        return eid

    def insert_batch(
        self, events, app_id: int, channel_id: int = 0,
        validate: bool = True,
    ) -> list[str]:
        events = list(events)
        if validate:
            # validate EVERYTHING before any shard writes: the single
            # store's all-or-nothing semantics must survive sharding
            for e in events:
                validate_event(e)
        groups: dict[int, list[int]] = {}
        for pos, e in enumerate(events):
            groups.setdefault(
                _shard_ix(e.entity_type, e.entity_id, self.n_shards), []
            ).append(pos)
        for six in groups:
            # refuse BEFORE any shard writes: all-or-nothing semantics
            # extend to a foreign shard in the batch
            self._check_writable(six)
        ids: list[Optional[str]] = [None] * len(events)
        # one bulk scope spanning every touched shard: a sqlite error
        # on a later group rolls back the earlier groups too.
        # defer_indexes=False — this scope exists for per-REQUEST
        # atomicity; whole-table index rebuilds per 50-event POST would
        # be quadratic steady-state ingest.  An importer's own
        # surrounding bulk() still defers (the outermost scope's flag
        # wins).
        with self.bulk(defer_indexes=False):
            for six, positions in groups.items():
                t0 = time.perf_counter()
                got = self.shards[six].insert_batch(
                    [events[p] for p in positions], app_id, channel_id,
                    validate=False,
                )
                self._m_write[six].observe(time.perf_counter() - t0)
                self._m_rows[six].inc(len(positions))
                for p, eid in zip(positions, got):
                    ids[p] = eid
        return ids  # aligned with the input order

    def insert_raw_rows(self, rows, app_id: int,
                        channel_id: int = 0) -> None:
        """Native-importer and WAL-drain fast path, shard-routed: row
        columns 2/3 are entity_type/entity_id (`sqlite_events._row`).
        Each shard's rows keep their input order."""
        rows = rows if isinstance(rows, list) else list(rows)
        groups: list[list] = [[] for _ in range(self.n_shards)]
        for row in rows:
            groups[_shard_ix(row[2], row[3], self.n_shards)].append(row)
        for six, grp in enumerate(groups):
            if grp:
                self._check_writable(six)
        # cross-shard atomicity as in insert_batch (and same reasoning
        # for defer_indexes=False: the importer's outer scope defers)
        with self.bulk(defer_indexes=False):
            for six, grp in enumerate(groups):
                if grp:
                    t0 = time.perf_counter()
                    self.shards[six].insert_raw_rows(grp, app_id,
                                                     channel_id)
                    self._m_write[six].observe(time.perf_counter() - t0)
                    self._m_rows[six].inc(len(grp))

    def purge_older_than(self, cutoff_millis: int, app_id: int,
                         channel_id: int = 0) -> int:
        """TTL fan-out (`sqlite_events.purge_older_than`) over every
        shard this process can write: in a worker fleet each owner trims
        its own files."""
        total = 0
        for i, s in enumerate(self.shards):
            if self.owned_shards is not None and i not in self.owned_shards:
                continue
            n = s.purge_older_than(cutoff_millis, app_id, channel_id)
            if n:
                self._m_rows[i].dec(n)
            total += n
        return total

    @contextlib.contextmanager
    def bulk(self, defer_indexes: bool = True):
        with contextlib.ExitStack() as stack:
            for s in self.shards:
                stack.enter_context(s.bulk(defer_indexes=defer_indexes))
            yield self

    def import_shard_files(self) -> Optional[list[Path]]:
        """The shard files a JSON-lines import may hand to one worker
        process each, or None when it must write here: one shard, a
        worker that owns only some shards, or a bulk scope already open
        on this thread.  Raises ``ShardUnavailableError`` for a shard
        that cannot be written, as a write would."""
        if (self.n_shards < 2 or self.owned_shards is not None
                or any(s._bulk_depth for s in self.shards)):
            return None
        for six in range(self.n_shards):
            self._check_writable(six)
        return [Path(s._path) for s in self.shards]

    def book_import(self, six: int, rows: int, seconds: float) -> None:
        """Book a shard's rows and write seconds that another process
        wrote for this store (the per-shard write families)."""
        self._m_write[six].observe(seconds)
        self._m_rows[six].inc(rows)

    # -- point reads ------------------------------------------------------
    def get(self, event_id: str, app_id: int,
            channel_id: int = 0) -> Optional[Event]:
        for s in self.shards:
            ev = s.get(event_id, app_id, channel_id)
            if ev is not None:
                return ev
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: int = 0) -> bool:
        # NO short-circuit: a client that re-posted an explicit eventId
        # under a DIFFERENT entity left copies in two shards; delete must
        # remove every copy, not the first one found
        removed = [
            s.delete(event_id, app_id, channel_id) for s in self.shards
        ]
        for i, ok in enumerate(removed):
            if ok:
                self._m_rows[i].dec()
        return any(removed)

    def delete_batch(
        self, event_ids: Iterable[str], app_id: int, channel_id: int = 0
    ) -> int:
        ids = list(event_ids)
        total = 0
        for i, s in enumerate(self.shards):
            n = s.delete_batch(ids, app_id, channel_id)
            if n:
                self._m_rows[i].dec(n)
            total += n
        return total

    # -- scans ------------------------------------------------------------
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
        kw = dict(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, reversed=reversed,
        )
        if entity_type is not None and entity_id is not None:
            # rowkey-locality fast path: one shard holds the entity
            yield from self._shard(entity_type, entity_id).find(
                limit=limit, **kw
            )
            return
        # k-way merge of per-shard time-ordered streams; each shard is
        # given the limit too (a merged top-N needs at most N per shard)
        streams = [s.find(limit=limit, **kw) for s in self.shards]
        key = (
            (lambda e: -e.event_time.timestamp()) if reversed
            else (lambda e: e.event_time.timestamp())
        )
        merged = heapq.merge(*streams, key=key)
        if limit is None or limit < 0:
            yield from merged
            return
        yield from itertools.islice(merged, limit)

    def find_ratings(
        self,
        app_id: int,
        channel_id: int = 0,
        event_names=("rate",),
        rating_property="rating",
        dedup: str = "last",
        entity_type=None,
        cache=None,
    ) -> Ratings:
        """Fused training read across shards: each shard runs its
        native scan+encode (`sqlite_events.find_ratings`, with its own
        scan-cache snapshot when ``cache`` is on), then the shard
        dictionaries merge into one global id space.

        Per-shard dedup is GLOBALLY exact here: routing is by entity,
        so every event of a (user, item) pair lives in the user's one
        shard — cross-shard duplicates of a pair cannot exist.

        The shards are scanned CONCURRENTLY, one thread each: the native
        scan releases the GIL (``ctypes``), so the read costs about the
        slowest shard's, not the sum.  The output is the shards' ratings
        concatenated in shard order, with global codes from the sorted
        unions of the shards' ids: the reference's sharded read, bit for
        bit (not the single-file store's order).
        ``last_ratings_shard_seconds`` and ``last_ratings_merge_seconds``
        keep the split of the last call."""
        from .bimap import StringIndex

        def scan(s: SQLiteEventStore):
            t0 = time.perf_counter()
            part = s.find_ratings(
                app_id, channel_id, event_names=event_names,
                rating_property=rating_property, dedup=dedup,
                entity_type=entity_type, cache=cache,
            )
            return part, time.perf_counter() - t0

        with ThreadPoolExecutor(len(self.shards),
                                thread_name_prefix="shard-scan") as ex:
            done = list(ex.map(scan, self.shards))
        t0 = time.perf_counter()
        parts = [p for p, _ in done]
        paths = {s.last_ratings_scan_path for s in self.shards}
        self.last_ratings_scan_path = (
            paths.pop() if len(paths) == 1 else "mixed"
        )
        reasons = [s.last_ratings_scan_reason for s in self.shards
                   if s.last_ratings_scan_reason]
        self.last_ratings_scan_reason = reasons[0] if reasons else None
        # dictionaries merge from EVERY part — a shard whose rows all
        # filtered out (e.g. propless ratings) still contributes its
        # ids, exactly like the single store's global factorize would
        users = StringIndex(sorted(set().union(
            *(p.users.ids.tolist() for p in parts)
        )))
        items = StringIndex(sorted(set().union(
            *(p.items.ids.tolist() for p in parts)
        )))
        u_out, i_out, v_out = [], [], []
        for p in parts:
            if not len(p):
                continue
            # shard-local code -> global code, one gather per side
            umap = users.encode(p.users.ids)
            imap = items.encode(p.items.ids)
            u_out.append(umap[p.user_ix])
            i_out.append(imap[p.item_ix])
            v_out.append(p.rating)
        if not u_out:
            u_out = [np.empty(0, np.int32)]
            i_out = [np.empty(0, np.int32)]
            v_out = [np.empty(0, np.float32)]
        out = Ratings(
            user_ix=np.concatenate(u_out).astype(np.int32),
            item_ix=np.concatenate(i_out).astype(np.int32),
            rating=np.concatenate(v_out).astype(np.float32),
            users=users,
            items=items,
        )
        self.last_ratings_shard_seconds = [s for _, s in done]
        self.last_ratings_merge_seconds = time.perf_counter() - t0
        return out

    def find_columnar(
        self,
        app_id: int,
        channel_id: int = 0,
        **kw,
    ) -> EventFrame:
        """Fan out the per-shard columnar scans, concatenate, and
        restore the contract's time ordering (one stable argsort over
        the merged time column)."""
        if (
            kw.get("entity_type") is not None
            and kw.get("entity_id") is not None
        ):
            # rowkey-locality fast path, same as find(): one shard
            # holds the entity — no fan-out, no re-sort needed
            return self._shard(
                kw["entity_type"], kw["entity_id"]
            ).find_columnar(app_id, channel_id, **kw)
        all_frames = [
            s.find_columnar(app_id, channel_id, **kw)
            for s in self.shards
        ]
        frames = [f for f in all_frames if len(f)]
        if not frames:
            return all_frames[0]

        def cat(name):
            cols = [getattr(f, name) for f in frames]
            if any(c is None for c in cols):
                return None
            return np.concatenate(cols)

        merged = EventFrame(
            event=cat("event"),
            entity_type=cat("entity_type"),
            entity_id=cat("entity_id"),
            target_entity_type=cat("target_entity_type"),
            target_entity_id=cat("target_entity_id"),
            event_time_ms=cat("event_time_ms"),
            properties=cat("properties"),
            value=cat("value"),
        )
        order = np.argsort(merged.event_time_ms, kind="stable")
        if np.array_equal(order, np.arange(len(order))):
            return merged
        return merged.select(order)

    # -- incremental scans (per-shard fold-in watermarks) -----------------
    #
    # The single-file store's watermark cursor is one rowid; a sharded
    # store has N independent rowid sequences, so its cursor is a
    # VECTOR — JSON-encoded ``{"0": rowid, "1": rowid, ...}`` — carried
    # opaquely by every consumer (pio-live watermark files, delta-link
    # metadata, online-eval cursors).  Integer 0 still means "from the
    # beginning" so single-file call sites work unchanged; any other
    # integer is refused loudly (it cannot name a position in N
    # sequences).

    def _decode_cursor(self, cursor) -> list[int]:
        if isinstance(cursor, str):
            try:
                d = json.loads(cursor)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"bad shard cursor {cursor!r}: {e}"
                ) from None
            if not isinstance(d, dict):
                raise ValueError(
                    f"shard cursor must be a JSON object, got {cursor!r}"
                )
            return [int(d.get(str(i), 0)) for i in range(self.n_shards)]
        c = int(cursor or 0)
        if c == 0:
            return [0] * self.n_shards
        raise ValueError(
            f"sharded event-store cursors are JSON shard-vector "
            f"strings; a nonzero integer ({c}) cannot address "
            f"{self.n_shards} independent rowid sequences"
        )

    def _encode_cursor(self, per_shard) -> str:
        return json.dumps(
            {str(i): int(v) for i, v in enumerate(per_shard)},
            sort_keys=True, separators=(",", ":"),
        )

    # advertised capability: one unbounded ``find_rows_since(...,
    # parallel=True)`` call walks every shard (the trending and nextitem
    # engines' full-backlog aggregation); callers probe this instead of
    # sniffing types
    supports_parallel_scan = True

    def find_rows_since(
        self,
        app_id: int,
        channel_id: int = 0,
        cursor=0,
        limit: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        newest_first: bool = False,
        parallel: bool = False,
        tolerate_unavailable: bool = False,
    ) -> tuple[list[tuple], str]:
        """Rows written after a shard-vector watermark; returns
        ``(rows, new_cursor)`` with ``new_cursor`` the JSON-encoded
        per-shard vector (see above).  Rows are the same
        ``(rowid, <11 columns>)`` tuples the single store yields —
        NOTE the rowid is shard-LOCAL (display/debug only; the cursor
        is the paging contract, never arithmetic on row ids).

        Ordering is per-shard rowid-ascending, shards concatenated in
        index order.  Per-ENTITY ordering — the property fold-in
        correctness rests on ("last rating wins" within a window) — is
        exact, because routing pins an entity to one shard.  ``limit``
        bounds the merged page: shards are consumed in order and the
        cursor only advances for rows actually returned, so paging
        with the returned cursor walks the full backlog without
        skipping or repeating.

        ``parallel=True`` is accepted for the reference's signature,
        whose store scans the shards from one thread each.  Here they
        are scanned in turn on the calling thread, which gives the same
        rows in the same order (shard-index order): the sqlite3 module
        gives up and takes back the GIL at every row it steps, so four
        threads hand the GIL to one another at every row, and took 8 to
        9 times as long as the same four scans in turn (300,000 rows of
        a 4-shard store: 11.5-12.9 s against 1.4-1.7 s on one CPU host).

        ``tolerate_unavailable=True`` is the pio-levee degradation mode
        for incremental consumers (fold-in, online eval): a shard that
        answers `ShardUnavailableError` contributes NO rows and its
        cursor COMPONENT does not advance — the vector stalls on
        exactly that shard while healthy components keep moving, so
        resuming from the returned cursor after recovery replays the
        dead shard's backlog from where it stalled, losing nothing.
        When False (default) the error propagates — one-shot readers
        must see the outage loudly, not a silently partial scan."""
        per_shard = self._decode_cursor(cursor)

        def scan_one(i, lim):
            """(rows, new_component) for shard i — stalled on outage
            when tolerated (component pinned at the input cursor)."""
            try:
                self._check_shard_up(i)
                t0 = time.perf_counter()
                rows, nc = self.shards[i].find_rows_since(
                    app_id, channel_id, cursor=per_shard[i],
                    limit=lim, event_names=event_names,
                    newest_first=newest_first,
                )
                self._m_scan[i].observe(time.perf_counter() - t0)
                return rows, int(nc)
            except ShardUnavailableError:
                if not tolerate_unavailable:
                    raise
                return [], int(per_shard[i])

        out_rows: list[tuple] = []
        new_cursor = list(per_shard)
        remaining = limit
        for i in range(self.n_shards):
            if remaining is not None and remaining <= 0:
                break
            rows, nc = scan_one(i, remaining)
            out_rows.extend(rows)
            new_cursor[i] = nc
            if remaining is not None:
                remaining -= len(rows)
        return out_rows, self._encode_cursor(new_cursor)

    def find_since(
        self,
        app_id: int,
        channel_id: int = 0,
        cursor=0,
        limit: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        newest_first: bool = False,
    ) -> tuple[list[tuple[int, Event]], str]:
        """:meth:`find_rows_since` decoded to ``(rowid, Event)`` pairs
        (shard-local rowids; the dashboard's recent-events view)."""
        rows, new_cursor = self.find_rows_since(
            app_id, channel_id, cursor, limit, event_names, newest_first
        )
        return (
            [(int(r[0]), SQLiteEventStore._event_from_row(r[1:]))
             for r in rows],
            new_cursor,
        )

    def max_rowid(self, app_id: int, channel_id: int = 0) -> int:
        """SUM of the per-shard high-water rowids: a scalar volume
        indicator (dashboards, coarse lag display), NOT a cursor —
        cursors are vectors (:meth:`high_water_cursor`)."""
        return sum(
            s.max_rowid(app_id, channel_id) for s in self.shards
        )

    def high_water_cursor(self, app_id: int, channel_id: int = 0) -> str:
        """The encoded shard-vector cursor at the current high-water
        mark (``foldin --from-now`` starts here)."""
        return self._encode_cursor([
            s.max_rowid(app_id, channel_id) for s in self.shards
        ])

    def cursor_lag(self, app_id: int, channel_id: int = 0,
                   cursor=0) -> int:
        """Rows written past ``cursor`` summed over shards — the
        freshness debt the watermark gauges report."""
        per_shard = self._decode_cursor(cursor)
        return sum(
            max(s.max_rowid(app_id, channel_id) - per_shard[i], 0)
            for i, s in enumerate(self.shards)
        )
