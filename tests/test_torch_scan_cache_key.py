"""The scan cache's snapshot key, keyed per table.

A snapshot of ``find_ratings`` or ``find_columnar`` is keyed on the
table's write version, the file's inode and a random token written once
into the file.  A write to another app's table of the same file (or
shard file) leaves the snapshot served; a write to the app's own table,
or a database deleted and recreated at the same path, misses; a bulk
scope that rolls back leaves the snapshot valid.  The reference keys on
the file's ctime instead, which any write to the file moves once it
reaches the main file (a WAL checkpoint): the tests checkpoint after the
write to hold the port to the per-table key.
"""

from __future__ import annotations

import datetime as dt
import shutil
import time

import numpy as np
import pytest

from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as JaxSQLiteEventStore,
)
from predictionio_tpu_torch.storage import (
    Event,
    ShardedSQLiteEventStore,
    SQLiteEventStore,
)
from predictionio_tpu_torch.storage import scan_cache

UTC = dt.timezone.utc
A, B = 1, 2
COLUMNAR = dict(event_names=["rate"], float_property="rating")


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path / "home"))


def _rates(seed: int, n: int = 60, prefix: str = "u") -> list:
    rng = np.random.default_rng(seed)
    t = dt.datetime(2026, 3, 1, tzinfo=UTC)
    return [Event(event="rate", entity_type="user",
                  entity_id=f"{prefix}{int(rng.integers(0, 12))}",
                  target_entity_type="item",
                  target_entity_id=f"i{int(rng.integers(0, 9))}",
                  properties={"rating": float(rng.integers(1, 6))},
                  event_time=t + dt.timedelta(seconds=k))
            for k in range(n)]


def _open(kind: str, root):
    if kind == "single":
        return SQLiteEventStore(root / "e.db")
    return ShardedSQLiteEventStore(root / "sh", n_shards=4)


def _files(es) -> list:
    return list(getattr(es, "shards", [es]))


def _reach_the_file(es) -> None:
    """Move what the WAL holds into each main file, as sqlite's
    auto-checkpoint does after 1,000 pages: the file's ctime moves."""
    time.sleep(0.02)
    for s in _files(es):
        s._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")


def _seeded(kind: str, root):
    es = _open(kind, root)
    for app in (A, B):
        es.init_channel(app)
    es.insert_batch(_rates(0), app_id=A)
    es.insert_batch(_rates(1), app_id=B)
    return es


def _columnar_hits(monkeypatch) -> list:
    """Every ``scan_cache.load`` call's outcome, True for a hit."""
    seen = []
    load = scan_cache.load

    def spy(key):
        got = load(key)
        seen.append(got is not None)
        return got

    monkeypatch.setattr(scan_cache, "load", spy)
    return seen


def _snapshot_both(es) -> tuple:
    """A's ratings and columns read twice: stored, then served."""
    first = es.find_ratings(A, cache=True)
    cols = es.find_columnar(A, cache=True, **COLUMNAR)
    assert es.find_ratings(A, cache=True).user_ix.tolist() == \
        first.user_ix.tolist()
    assert es.last_ratings_scan_path == "cache"
    return first, cols


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_a_write_to_another_app_leaves_the_snapshots_hit(
        kind, tmp_path, monkeypatch):
    es = _seeded(kind, tmp_path)
    first, cols = _snapshot_both(es)
    es.insert_batch(_rates(2, n=40, prefix="w"), app_id=B)
    _reach_the_file(es)
    hits = _columnar_hits(monkeypatch)
    again = es.find_ratings(A, cache=True)
    assert es.last_ratings_scan_path == "cache"
    assert all(s.last_ratings_scan_path == "cache"
               for s in getattr(es, "shards", ()))
    assert again.rating.tobytes() == first.rating.tobytes()
    got = es.find_columnar(A, cache=True, **COLUMNAR)
    assert hits and all(hits)
    assert got.value.tobytes() == cols.value.tobytes()


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_a_write_to_the_app_misses(kind, tmp_path, monkeypatch):
    """Each file the write reached misses; on the sharded store a shard
    the write did not reach still serves its snapshot."""
    es = _seeded(kind, tmp_path)
    _snapshot_both(es)
    v0 = [s._version("events_1") for s in _files(es)]
    es.insert_batch(_rates(3, n=5, prefix="new"), app_id=A)
    written = [s._version("events_1") != v for s, v in zip(_files(es), v0)]
    assert any(written)
    hits = _columnar_hits(monkeypatch)
    after = es.find_ratings(A, cache=True)
    assert [s.last_ratings_scan_path for s in _files(es)] == [
        "native" if w else "cache" for w in written]
    assert any(u.startswith("new") for u in after.users.ids.tolist())
    cols = es.find_columnar(A, cache=True, **COLUMNAR)
    assert hits == [not w for w in written]
    assert len(cols.value) == 65


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_a_recreated_database_misses(kind, tmp_path, monkeypatch):
    """The same path, the same writes (so the same versions) and other
    ratings: the snapshot of the deleted file must not be served."""
    root = tmp_path / "db"
    root.mkdir()
    es = _seeded(kind, root)
    _snapshot_both(es)
    before = [s._snapshot_fingerprint("events_1") for s in _files(es)]
    es.close()
    shutil.rmtree(root)
    root.mkdir()
    es = _open(kind, root)
    for app in (A, B):
        es.init_channel(app)
    es.insert_batch(_rates(7), app_id=A)
    es.insert_batch(_rates(1), app_id=B)
    hits = _columnar_hits(monkeypatch)
    got = es.find_ratings(A, cache=True)
    assert es.last_ratings_scan_path == "native"
    want = SQLiteEventStore(tmp_path / "fresh.db")
    want.init_channel(A)
    want.insert_batch(_rates(7), app_id=A)
    if kind == "single":
        assert got.rating.tobytes() == want.find_ratings(A).rating.tobytes()
    es.find_columnar(A, cache=True, **COLUMNAR)
    assert hits and not any(hits)
    after = [s._snapshot_fingerprint("events_1") for s in _files(es)]
    # equal versions, and a token of its own for each new file
    assert [f[0] for f in after] == [f[0] for f in before]
    assert all(a[2] != b[2] for a, b in zip(after, before))


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_a_rolled_back_bulk_scope_leaves_the_snapshot_valid(
        kind, tmp_path, monkeypatch):
    es = _seeded(kind, tmp_path)
    first, _ = _snapshot_both(es)
    with pytest.raises(RuntimeError):
        with es.bulk():
            es.insert_batch(_rates(4, prefix="gone"), app_id=A)
            raise RuntimeError("abort the import")
    hits = _columnar_hits(monkeypatch)
    again = es.find_ratings(A, cache=True)
    assert es.last_ratings_scan_path == "cache"
    assert again.rating.tobytes() == first.rating.tobytes()
    es.find_columnar(A, cache=True, **COLUMNAR)
    assert hits and all(hits)


def test_the_token_is_written_once_and_the_reference_reads_past_it(
        tmp_path):
    """Two stores on one file read one token; the JAX package opens the
    file with the token row in ``_scan_versions`` and reads the same
    ratings."""
    es = _seeded("single", tmp_path)
    one = es._snapshot_fingerprint("events_1")
    other = SQLiteEventStore(tmp_path / "e.db")
    assert other._snapshot_fingerprint("events_1") == one
    ref = JaxSQLiteEventStore(tmp_path / "e.db")
    got, want = es.find_ratings(A), ref.find_ratings(A)
    assert got.rating.tobytes() == want.rating.tobytes()
    assert got.users.ids.tolist() == want.users.ids.tolist()
