"""Thread-serialized sqlite connection wrapper.

Copy of ``predictionio_tpu/storage/_sqlite_util.py`` for the port.  The
stdlib ``sqlite3`` module requires each *connection object* to be used by
one thread at a time even with ``check_same_thread=False``: interleaved
statement execution from several threads raises ``sqlite3.InterfaceError:
bad parameter or other API misuse``.  Thread-local connections solve it
for file-backed stores; ``:memory:`` databases and the metadata store
(one small db, many cheap statements) instead share ONE connection
through this wrapper, which holds the store's lock across execute+fetch
and returns fully materialized results so no cursor ever escapes the
lock.
"""

from __future__ import annotations

import threading


class MaterializedCursor:
    """Rows fetched eagerly inside the lock; cursor-shaped reads after."""

    __slots__ = ("_rows", "_i", "lastrowid", "rowcount")

    def __init__(self, rows, lastrowid, rowcount):
        self._rows = rows
        self._i = 0
        self.lastrowid = lastrowid
        self.rowcount = rowcount

    def fetchone(self):
        if self._i < len(self._rows):
            row = self._rows[self._i]
            self._i += 1
            return row
        return None

    def fetchmany(self, size=1000):
        rows = self._rows[self._i:self._i + size]
        self._i += len(rows)
        return rows

    def fetchall(self):
        if self._i == 0:
            self._i = len(self._rows)
            return self._rows        # callers never mutate; avoid a copy
        rows = self._rows[self._i:]
        self._i = len(self._rows)
        return rows

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row


class SerializedConnection:
    """One underlying connection, every statement serialized by a lock.

    Results are materialized before the lock releases — small-table
    stores only (metadata, ``:memory:`` event stores); big scans belong
    on per-thread connections.
    """

    def __init__(self, conn, lock: threading.RLock):
        self._conn = conn
        self._lock = lock

    def execute(self, sql, params=()):
        with self._lock:
            cur = self._conn.execute(sql, params)
            rows = cur.fetchall() if cur.description is not None else []
            return MaterializedCursor(rows, cur.lastrowid, cur.rowcount)

    def executemany(self, sql, seq):
        with self._lock:
            cur = self._conn.executemany(sql, seq)
            return MaterializedCursor([], cur.lastrowid, cur.rowcount)

    def executescript(self, script):
        with self._lock:
            self._conn.executescript(script)

    def commit(self):
        with self._lock:
            self._conn.commit()

    def rollback(self):
        with self._lock:
            self._conn.rollback()

    def close(self):
        with self._lock:
            self._conn.close()
