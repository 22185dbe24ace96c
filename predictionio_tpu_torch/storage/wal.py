"""Crash-safe group-commit write-ahead log for the ingest edge.

Port of ``predictionio_tpu/storage/wal.py``, for the single-file store
and the sharded one (one log per owned shard, routed by the store's own
entity hash).  The log format is the reference's, so either package
replays the other's logs.  With the reference's fault-injection points
(``wal.torn``, ``store.shard_down``), ``obs`` metrics and timed locks.

The reference's HBase write path acknowledges a put only after the
region server's WAL has the record (hflush), then folds memstore
batches into files later.  Our sqlite stores commit per REST request —
durable, but the commit machinery (executemany + index maintenance +
version bump per 50-row batch) rides every request.  This module splits
the two jobs the way the reference does:

* **Ack = WAL fsync.**  A request's rows are framed, appended to the
  owning shard's log, and fsynced BEFORE the 2xx goes out.  Concurrent
  requests group-commit: the first submitter in becomes the *leader*,
  drains everything pending, and pays ONE write + fsync for the group
  (followers return as soon as the leader's flush covers them).
* **Sqlite commit = background drain.**  A committer thread folds
  acknowledged rows into the store in large ``insert_raw_rows`` batches
  (one transaction per drain), so steady-state ingest pays importer-
  style amortized commit costs instead of per-request ones.  Once the
  drain catches up, the logs are truncated (checkpoint).
* **Restart = replay.**  Rows acknowledged but not yet committed are
  re-inserted from the logs at startup.  Replay is at-least-once — a
  record may already be in sqlite if the crash hit between commit and
  truncate — and `INSERT OR REPLACE` on the event id makes that
  idempotent.  A torn trailing record (crash mid-append) is dropped:
  its submitter never got an ack, so dropping it loses nothing
  acknowledged.

File format, one log per shard (``shard-<i>.wal``): each record is
``<crc32:4><len:4><payload>`` little-endian, payload = compact JSON
``[app_id, channel_id, row]`` with ``row`` the 11-column tuple of
`sqlite_events.event_to_row`.  Replay stops at the first short or
crc-mismatched frame and truncates the file there.

Failure discipline is fail-stop per shard: an append that errors
(including an injected ``wal.torn``) marks that shard's log broken and
every later write to the shard answers `ShardUnavailableError` until a
restart replays and truncates the log — a write path whose durability
log is suspect must stop acknowledging, not guess.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sqlite3
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Iterable, Optional

from ..obs import (
    WAL_BACKLOG_ROWS,
    WAL_COMMIT_ROWS,
    WAL_FSYNC_SECONDS,
    WAL_REPLAYED_TOTAL,
    scope,
)
from ..resilience import faults
from .levents import ShardUnavailableError

logger = logging.getLogger(__name__)

__all__ = ["EventWAL", "GroupCommitWAL", "replay_wal_dir"]

_HEADER = struct.Struct("<II")  # crc32(payload), len(payload)


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(zlib.crc32(payload), len(payload)) + payload


def _encode_record(app_id: int, channel_id: int, row) -> bytes:
    return json.dumps(
        [app_id, channel_id, list(row)], separators=(",", ":")
    ).encode("utf-8", "surrogatepass")


def _decode_record(payload: bytes) -> tuple[int, int, tuple]:
    app_id, channel_id, row = json.loads(payload.decode("utf-8",
                                                        "surrogatepass"))
    return int(app_id), int(channel_id), tuple(row)


def read_records(path) -> tuple[list[tuple[int, int, tuple]], int, bool]:
    """Parse a WAL file: ``(records, good_size, torn)``.

    ``good_size`` is the byte offset after the last intact frame;
    ``torn`` reports whether trailing bytes past it were dropped (short
    frame or crc mismatch — a crash mid-append).  Never raises on tail
    damage; a corrupt PREFIX cannot occur (frames are written in order
    and fsynced in order)."""
    try:
        data = Path(path).read_bytes()
    except FileNotFoundError:
        return [], 0, False
    records: list[tuple[int, int, tuple]] = []
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        crc, ln = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + ln
        if end > n:
            break  # torn: header promises more bytes than exist
        payload = data[off + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            break  # torn mid-payload (or never completed)
        try:
            records.append(_decode_record(payload))
        except (ValueError, UnicodeDecodeError):
            break  # crc passed but content is garbage: treat as torn
        off = end
    return records, off, off != n


class EventWAL:
    """One shard's append-only log.  NOT internally locked: the group
    commit serializes every append under its flush lock (single-writer
    discipline), and replay runs before the writer exists."""

    def __init__(self, path, shard_ix: int):
        self.path = Path(path)
        self.shard_ix = shard_ix
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # recovery happens BEFORE opening for append (replay_wal_dir);
        # here we only position at the durable tail, truncating any
        # torn bytes so later appends never land after garbage
        _, good, torn = read_records(self.path)
        self._f = open(self.path, "ab")
        if torn:
            self._f.truncate(good)
        self.size = good
        self.broken: Optional[str] = None

    def append_group(self, payloads: Iterable[bytes]) -> None:
        """Append framed records and fsync: the leader's one durable
        write per group.  ``wal.torn`` (shard-scoped) tears the write
        mid-record: half the buffer lands, no fsync, and the log is
        marked broken — the simulated crash replay recovers from."""
        if self.broken is not None:
            raise ShardUnavailableError(
                self.shard_ix, f"ingest WAL broken: {self.broken}"
            )
        buf = b"".join(_frame(p) for p in payloads)
        if not buf:
            return
        try:
            faults.check_shard("wal.torn", self.shard_ix)
        except BaseException as e:
            torn = buf[: max(len(buf) // 2, _HEADER.size - 1)]
            self._f.write(torn)
            self._f.flush()
            self.broken = f"{type(e).__name__}: {e}"
            raise ShardUnavailableError(
                self.shard_ix, f"ingest WAL torn: {e}"
            ) from e
        try:
            self._f.write(buf)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            self.broken = f"{type(e).__name__}: {e}"
            raise ShardUnavailableError(
                self.shard_ix, f"ingest WAL append failed: {e}"
            ) from e
        self.size += len(buf)

    def truncate(self) -> None:
        """Checkpoint: every logged record is committed — reset to
        empty.  Caller holds the flush lock (no concurrent appends)."""
        self._f.truncate(0)
        self._f.seek(0)
        os.fsync(self._f.fileno())
        self.size = 0

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def replay_wal_dir(wal_dir, store, shards: Optional[Iterable[int]] = None,
                   truncate: bool = True) -> dict:
    """Fold acknowledged-but-uncommitted rows back into ``store``.

    Scans ``shard-<i>.wal`` files under ``wal_dir`` (all of them, or
    just ``shards``), inserts every intact record via
    ``insert_raw_rows`` (grouped by (app, channel), one bulk scope —
    at-least-once + INSERT OR REPLACE = exactly-once effect), then
    truncates the replayed logs.  Returns
    ``{"replayed", "torn_shards", "shards"}`` for boot logs/smokes."""
    wal_dir = Path(wal_dir)
    replayed = 0
    torn_shards: list[int] = []
    seen_shards: list[int] = []
    if not wal_dir.is_dir():
        return {"replayed": 0, "torn_shards": [], "shards": []}
    paths = sorted(wal_dir.glob("shard-*.wal"))
    want = None if shards is None else {int(s) for s in shards}
    for p in paths:
        try:
            six = int(p.stem.split("-", 1)[1])
        except (IndexError, ValueError):
            continue
        if want is not None and six not in want:
            continue
        records, good, torn = read_records(p)
        seen_shards.append(six)
        if torn:
            torn_shards.append(six)
        if records:
            groups: dict[tuple[int, int], list[tuple]] = {}
            for app_id, channel_id, row in records:
                groups.setdefault((app_id, channel_id), []).append(row)
            for (app_id, channel_id), rows in sorted(groups.items()):
                store.init_channel(app_id, channel_id)
                store.insert_raw_rows(rows, app_id, channel_id)
            replayed += len(records)
            WAL_REPLAYED_TOTAL.labels(shard=str(six)).inc(len(records))
        if truncate and (records or torn):
            # replayed content is committed (insert_raw_rows commits);
            # only now is dropping the log safe
            with open(p, "r+b") as f:
                f.truncate(0)
                f.flush()
                os.fsync(f.fileno())
    if replayed or torn_shards:
        logger.info(
            "ingest WAL replay: %d records into %s (torn tails on "
            "shards %s)", replayed, wal_dir, torn_shards or "none",
        )
    return {"replayed": replayed, "torn_shards": torn_shards,
            "shards": seen_shards}


class GroupCommitWAL:
    """Owner-level group commit over per-shard logs.

    ``submit`` is the ingest edge's whole write path: route rows to
    shards, refuse non-owned or down shards, group-commit to the WAL
    (ack), and queue for the background sqlite drain.  ``barrier``
    gives the server's own read routes read-your-writes.

    Lock order: ``_flush_lock`` (leader election, serializes WAL
    appends and checkpoints) is taken OUTSIDE ``_lock`` (pending/seq
    bookkeeping, commit queue).  The committer thread takes them in the
    same order.
    """

    def __init__(self, store, wal_dir,
                 owned_shards: Optional[Iterable[int]] = None,
                 commit_interval_s: float = 0.02,
                 max_commit_rows: int = 20_000,
                 shard_ix=None,
                 replay: bool = True):
        self._store = store
        self.wal_dir = Path(wal_dir)
        self.n_shards = int(getattr(store, "n_shards", 1))
        self.owned = (
            frozenset(range(self.n_shards)) if owned_shards is None
            else frozenset(int(s) for s in owned_shards)
        )
        bad = [s for s in self.owned if not 0 <= s < self.n_shards]
        if bad:
            raise ValueError(
                f"owned shards {bad} out of range for "
                f"{self.n_shards}-shard store"
            )
        self.commit_interval_s = commit_interval_s
        self.max_commit_rows = max_commit_rows
        # shard_ix(entity_type, entity_id, n) — injected so this module
        # needs no import of sharded_events (which stays WAL-free); the
        # single-file store routes everything to shard 0
        if shard_ix is None and self.n_shards > 1:
            from .sharded_events import _shard_ix as shard_ix
        self._shard_ix = shard_ix
        self.replay_report = (
            replay_wal_dir(self.wal_dir, store, shards=self.owned)
            if replay else {"replayed": 0, "torn_shards": [],
                            "shards": []}
        )
        self._wals = {
            six: EventWAL(self.wal_dir / f"shard-{six}.wal", six)
            for six in sorted(self.owned)
        }
        # pio-scope: the two ingest hot locks.  "wal_commit" is the
        # bookkeeping monitor every submit and the committer share;
        # "wal_flush" serializes group leaders — its wait histogram IS
        # the follower-waiting-on-a-leader's-fsync distribution.
        self._lock = scope.TimedLock("wal_commit")
        self._cv = scope.TimedCondition("wal_commit", lock=self._lock)
        self._flush_lock = scope.TimedLock("wal_flush")
        # (shard, payload bytes, (app, ch, row)) triples awaiting the
        # next leader's flush; commit queue holds flushed rows awaiting
        # the sqlite drain — both strictly FIFO so per-shard rowid
        # order matches ack order
        self._pending: list[tuple[int, bytes, tuple]] = []
        self._commit_q: collections.deque = collections.deque()
        self._submitted = 0
        self._flushed = 0
        self._committed = 0
        # (lo, hi] seq ranges whose flush failed — followers covered by
        # a failed leader must raise, not ack (bounded: old ranges are
        # harmless, seqs never reset)
        self._failures: collections.deque = collections.deque(maxlen=32)
        self._commit_now = False
        self._closing = False
        self._committer = threading.Thread(
            target=self._commit_loop, name="wal-committer", daemon=True,
        )
        self._committer.start()

    # -- write path -------------------------------------------------------
    def route(self, entity_type: str, entity_id: str) -> int:
        if self.n_shards <= 1:
            return 0
        return self._shard_ix(entity_type, entity_id, self.n_shards)

    def _guard(self, six: int) -> None:
        if six not in self.owned:
            raise ShardUnavailableError(
                six, "not owned by this worker (router misroute?)"
            )
        try:
            faults.check_shard("store.shard_down", six)
        except ShardUnavailableError:
            raise
        except BaseException as e:
            raise ShardUnavailableError(six, str(e)) from e
        wal = self._wals[six]
        if wal.broken is not None:
            raise ShardUnavailableError(
                six, f"ingest WAL broken: {wal.broken}"
            )

    def submit(self, app_id: int, channel_id: int, rows) -> None:
        """Durably log ``rows`` (11-column event_to_row tuples); when
        this returns, every row is fsynced in its shard's WAL and the
        caller may acknowledge.  Raises `ShardUnavailableError` for a
        down/foreign shard (nothing is logged) and propagates WAL
        append failures (nothing acknowledged)."""
        blobs: list[tuple[int, bytes, tuple]] = []
        for row in rows:
            six = self.route(row[2], row[3])
            self._guard(six)
            blobs.append((
                six,
                _encode_record(app_id, channel_id, row),
                (six, app_id, channel_id, row),
            ))
        if not blobs:
            return
        with self._lock:
            self._pending.extend(blobs)
            self._submitted += len(blobs)
            my_seq = self._submitted
        t0 = time.perf_counter()
        with self._flush_lock:
            with self._lock:
                covered = self._flushed >= my_seq
                if not covered:
                    batch, self._pending = self._pending, []
            if not covered and batch:
                self._flush_group(batch)
        WAL_FSYNC_SECONDS.child().observe(time.perf_counter() - t0)
        with self._lock:
            lo = my_seq - len(blobs)
            for flo, fhi, err in self._failures:
                if lo < fhi and my_seq > flo:
                    raise ShardUnavailableError(
                        blobs[0][0], f"group flush failed: {err}"
                    )

    def _flush_group(self, batch) -> None:
        """Leader: write + fsync one group (caller holds _flush_lock).
        On failure the whole group is marked failed — no row in it was
        durably acknowledged."""
        by_shard: dict[int, list[bytes]] = {}
        for six, payload, _ in batch:
            by_shard.setdefault(six, []).append(payload)
        try:
            for six in sorted(by_shard):
                self._wals[six].append_group(by_shard[six])
        except BaseException as e:
            with self._lock:
                lo = self._flushed
                self._flushed += len(batch)
                # nothing in a failed group was acknowledged, so there
                # is nothing to drain: count the rows resolved or every
                # later barrier() would wait on them forever
                self._committed += len(batch)
                self._failures.append(
                    (lo, self._flushed, f"{type(e).__name__}: {e}")
                )
                self._cv.notify_all()
            raise
        with self._lock:
            self._flushed += len(batch)
            self._commit_q.extend(item for _, _, item in batch)
            WAL_BACKLOG_ROWS.child().set(float(len(self._commit_q)))
            self._cv.notify_all()

    # -- read-your-writes barrier ----------------------------------------
    def barrier(self, timeout_s: float = 10.0) -> None:
        """Block until everything acknowledged before this call is
        committed into sqlite (the server's GET routes call this so a
        201 is immediately visible to the poster).  A drain stuck past
        ``timeout_s`` raises ``sqlite3.OperationalError`` — the same
        transient-storage surface the 503 path already speaks."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            target = self._flushed
            self._commit_now = True
            self._cv.notify_all()
            while self._committed < target:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise sqlite3.OperationalError(
                        f"ingest WAL drain backlog "
                        f"({target - self._committed} rows) did not "
                        f"clear in {timeout_s}s"
                    )
                self._cv.wait(left)

    def pending_rows(self) -> int:
        with self._lock:
            return len(self._commit_q)

    # -- background sqlite drain -----------------------------------------
    def _commit_loop(self) -> None:
        scope.register_thread_role("wal_committer")
        while True:
            with self._lock:
                while (not self._commit_q and not self._closing):
                    self._cv.wait()
                if self._closing and not self._commit_q:
                    return
                # accumulation window: let a few more groups land so one
                # transaction commits hundreds of rows, not 50.  Every
                # flush notifies, so the wait runs to its deadline (a
                # barrier or close ends it early)
                deadline = time.monotonic() + self.commit_interval_s
                while not self._commit_now and not self._closing:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                self._commit_now = False
                batch = []
                while self._commit_q and len(batch) < self.max_commit_rows:
                    batch.append(self._commit_q.popleft())
                WAL_BACKLOG_ROWS.child().set(float(len(self._commit_q)))
            if not batch:
                continue
            try:
                self._drain(batch)
            except Exception as e:
                # rows here are fsynced + acknowledged: NEVER drop.
                # Re-queue at the front (order preserved) and retry
                # with a bounded backoff; a restart would replay them
                # from the WAL anyway.
                logger.warning("WAL drain failed (%s); retrying", e)
                with self._lock:
                    self._commit_q.extendleft(reversed(batch))
                    WAL_BACKLOG_ROWS.child().set(
                        float(len(self._commit_q))
                    )
                time.sleep(min(self.commit_interval_s * 5, 0.5))
                continue
            with self._lock:
                self._committed += len(batch)
                fully_drained = (not self._commit_q
                                 and self._committed >= self._flushed)
                self._cv.notify_all()
            WAL_COMMIT_ROWS.child().observe(len(batch))
            if fully_drained:
                self._checkpoint()

    def _drain(self, batch) -> None:
        groups: dict[tuple[int, int], list[tuple]] = {}
        for _, app_id, channel_id, row in batch:
            groups.setdefault((app_id, channel_id), []).append(row)
        for (app_id, channel_id), rows in groups.items():
            self._store.insert_raw_rows(rows, app_id, channel_id)

    def _checkpoint(self) -> None:
        """Truncate fully-committed logs (bounds replay to the last
        in-flight window).  Leader lock excludes concurrent appends;
        re-check drained-ness under _lock once inside."""
        with self._flush_lock:
            with self._lock:
                if self._commit_q or self._committed < self._flushed:
                    return
            for wal in self._wals.values():
                if wal.size and wal.broken is None:
                    try:
                        wal.truncate()
                    except OSError as e:
                        wal.broken = f"{type(e).__name__}: {e}"

    def close(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the committer (draining acknowledged rows first unless
        ``drain=False`` — the crash-simulation hook the kill -9 tests
        use) and close the logs."""
        if drain:
            try:
                self.barrier(timeout_s=timeout_s)
            except sqlite3.OperationalError:
                logger.warning(
                    "ingest WAL close: drain did not finish; remaining "
                    "rows will replay on next start"
                )
        with self._lock:
            self._closing = True
            if not drain:
                self._commit_q.clear()
            self._cv.notify_all()
        self._committer.join(timeout=timeout_s)
        for wal in self._wals.values():
            wal.close()
