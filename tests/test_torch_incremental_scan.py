"""The event stores' incremental scans against the JAX package's, on the
CPU, and the sharded import's worker processes.

The same seeded events go into the port's and the reference's
single-file and 4-shard stores.  ``find_rows_since`` / ``find_since``
give the reference's rows and cursors (an int rowid, or the JSON shard
vector): paged by ``limit`` with nothing skipped or repeated, with an
``INSERT OR REPLACE`` re-entering the window, ``newest_first``, the
parallel shard scan and a shard that is down under
``tolerate_unavailable``; ``max_rowid``, ``high_water_cursor`` and
``cursor_lag`` agree, and so does ``scan_new_ratings``.  The sharded
store's JSON-lines import through four worker processes stores the
rows and rowids one writer stores; a failed
import, by scope or by worker, rolls every shard back.
"""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.live.watermark import (
    scan_new_ratings as jax_scan_new_ratings,
)
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.sharded_events import (
    ShardedSQLiteEventStore as JaxSharded,
)
from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as JaxSQLite,
)
from predictionio_tpu_torch.live import scan_new_ratings
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.storage import (
    Event,
    ShardedSQLiteEventStore,
    ShardUnavailableError,
)
from predictionio_tpu_torch.storage.event import EventValidationError
from predictionio_tpu_torch.storage.sqlite_events import SQLiteEventStore
from predictionio_tpu_torch.tools import import_export
from predictionio_tpu_torch.tools.import_export import import_events

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
KINDS = ("single", "sharded")


def _specs(seed: int, n: int, start: int = 0) -> list[dict]:
    """Rate events (a few without a rating, a few by another entity
    type), views and item ``$set`` events, each with its own id and a
    fixed creation time."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(start, start + n):
        spec = dict(event_id=f"e{k:05d}", event_time=T0 + dt.timedelta(
            milliseconds=int(rng.integers(0, 10_000))), creation_time=T0)
        kind = rng.random()
        if kind < 0.75:
            props = ({"rating": float(rng.integers(1, 11) * 0.5)}
                     if rng.random() > 0.05 else {"note": "none"})
            spec.update(event="rate", entity_type="user" if rng.random()
                        > 0.05 else "admin", entity_id=f"u{rng.integers(30)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(20)}",
                        properties=props)
        elif kind < 0.85:
            spec.update(event="view", entity_type="user",
                        entity_id=f"u{rng.integers(30)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(20)}")
        else:
            spec.update(event="$set", entity_type="item",
                        entity_id=f"i{rng.integers(20)}",
                        properties={"categories": ["c"]})
        out.append(spec)
    return out


def _stores(tmp_path, kind: str, specs=()):
    """(port store, reference store) of ``kind``, each with ``specs``."""
    if kind == "single":
        pair = (SQLiteEventStore(tmp_path / "port.db"),
                JaxSQLite(tmp_path / "jax.db"))
    else:
        pair = (ShardedSQLiteEventStore(tmp_path / "port", 4),
                JaxSharded(tmp_path / "jax", 4))
    for s, ev in zip(pair, (Event, JaxEvent)):
        s.init_channel(1)
        _put(s, ev, specs)
    return pair


def _put(store, ev, specs) -> None:
    if specs:
        store.insert_batch([ev(**x) for x in specs], 1)


def _both(port, jax, method, *args, **kw):
    got = getattr(port, method)(1, *args, **kw)
    want = getattr(jax, method)(1, *args, **kw)
    if method == "find_since":
        got = ([(r, e.to_json()) for r, e in got[0]], got[1])
        want = ([(r, e.to_json()) for r, e in want[0]], want[1])
    assert got == want, method
    return got


@pytest.mark.parametrize("kind", KINDS)
def test_scans_and_cursors_equal_the_references(tmp_path, kind):
    port, jax = _stores(tmp_path, kind, _specs(0, 300))
    hw = _both(port, jax, "high_water_cursor")
    assert hw == 300 if kind == "single" else sum(
        json.loads(hw).values()) == 300
    assert _both(port, jax, "max_rowid") == 300
    if kind == "sharded":  # every shard at once: the same rows
        assert _both(port, jax, "find_rows_since", parallel=True) == (
            port.find_rows_since(1))
    for cursor in (0, hw):
        for method in ("find_rows_since", "find_since"):
            _both(port, jax, method, cursor=cursor)
            _both(port, jax, method, cursor=cursor, event_names=["rate"])
        assert port.cursor_lag(1, cursor=cursor) == jax.cursor_lag(
            1, cursor=cursor) == (300 if cursor == 0 else 0)
    _put(port, Event, _specs(1, 40, 300))
    _put(jax, JaxEvent, _specs(1, 40, 300))
    assert port.cursor_lag(1, cursor=hw) == jax.cursor_lag(
        1, cursor=hw) == 40
    rows, new = _both(port, jax, "find_rows_since", cursor=hw)
    assert len(rows) == 40 and new == _both(port, jax, "high_water_cursor")


@pytest.mark.parametrize("kind", KINDS)
def test_paging_skips_and_repeats_nothing_either_way(tmp_path, kind):
    port, jax = _stores(tmp_path, kind, _specs(2, 250))
    seen = []
    cursor = 0
    while True:
        rows, new = _both(port, jax, "find_rows_since", cursor=cursor,
                          limit=37)
        if not rows:
            assert new == cursor or kind == "sharded"
            break
        assert len(rows) <= 37
        seen += [r[1] for r in rows]
        cursor = new
    assert sorted(seen) == sorted(x["event_id"] for x in _specs(2, 250))
    # newest first: the rows reversed, the cursor contract unchanged
    rows, new = _both(port, jax, "find_rows_since", newest_first=True)
    asc, new_asc = _both(port, jax, "find_rows_since")
    assert new == new_asc
    if kind == "single":
        assert [r[0] for r in rows] == sorted(
            (r[0] for r in asc), reverse=True)
    _both(port, jax, "find_since", newest_first=True, limit=10)


@pytest.mark.parametrize("kind", KINDS)
def test_a_replaced_event_re_enters_the_window(tmp_path, kind):
    specs = _specs(3, 120)
    port, jax = _stores(tmp_path, kind, specs)
    hw = _both(port, jax, "high_water_cursor")
    again = [{**specs[k], "properties": {"rating": 9.5}}
             for k in (5, 50) if specs[k]["event"] == "rate"] or [
        {**specs[0], "properties": {"rating": 9.5}}]
    _put(port, Event, again)
    _put(jax, JaxEvent, again)
    rows, _ = _both(port, jax, "find_rows_since", cursor=hw)
    assert sorted(r[1] for r in rows) == sorted(x["event_id"] for x in again)
    assert _both(port, jax, "max_rowid") == 120 + len(again)


def test_a_down_shard_stalls_only_its_cursor_component(tmp_path):
    port, jax = _stores(tmp_path, "sharded", _specs(6, 200))
    got = {}
    for pkg, store, f in (("port", port, faults), ("jax", jax, jax_faults)):
        f.arm("store.shard_down:shard=2")
        try:
            with pytest.raises(Exception) as err:
                store.find_rows_since(1)
            assert err.type.__name__ == "ShardUnavailableError"
            rows, cursor = store.find_rows_since(1, tolerate_unavailable=True)
        finally:
            f.disarm()
        resumed, full = store.find_rows_since(1, cursor=cursor)
        got[pkg] = (rows, cursor, resumed, full)
    assert got["port"] == got["jax"]
    rows, cursor, resumed, full = got["port"]
    assert json.loads(cursor)["2"] == 0
    assert json.loads(full) == json.loads(port.high_water_cursor(1))
    assert len(rows) + len(resumed) == 200
    assert issubclass(ShardUnavailableError, Exception)


@pytest.mark.parametrize("kind", KINDS)
def test_scan_new_ratings_equals_the_references(tmp_path, kind):
    port, jax = _stores(tmp_path, kind, _specs(7, 300))
    for kw in ({}, {"rating_property": None}, {"limit": 50},
               {"entity_type": None}):
        a = scan_new_ratings(port, 1, **kw)
        b = jax_scan_new_ratings(jax, 1, **kw)
        assert (a.user_ids, a.item_ids, a.n_events, a.cursor,
                a.new_cursor) == (b.user_ids, b.item_ids, b.n_events,
                                  b.cursor, b.new_cursor)
        assert a.values.dtype == b.values.dtype
        assert a.values.tobytes() == b.values.tobytes()


def _import(tmp_path, name: str, src, processes: bool):
    """``src`` into a fresh 4-shard store by a worker process a shard,
    or by one writer (the store then offers the workers no files)."""
    store = ShardedSQLiteEventStore(tmp_path / name, 4)
    if not processes:
        store.import_shard_files = lambda: None
    counts = {}
    assert import_events(src, store, 1, counts=counts) == 600
    return store, counts


def _events_file(tmp_path, seed: int):
    """600 events as JSON lines, every 7th with an escape that sends it
    through ``Event.from_json``."""
    src = tmp_path / "events.jsonl"
    with open(src, "w", encoding="utf-8") as f:
        for k, x in enumerate(_specs(seed, 600)):
            line = json.dumps(Event(**x).to_json())
            if k % 7 == 0:
                line = line.replace('"entityId": "', '"entityId": "\\u0075', 1)
            f.write(line + "\n")
    return src


@pytest.mark.parametrize("chunk", ["processes", "processes-4kib-blocks"])
def test_parallel_writers_store_what_one_writer_stores(tmp_path, chunk,
                                                      monkeypatch):
    """The JSON-lines import (native rows and re-parsed lines mixed)
    through four worker processes, fed the file in one block or in 4 KiB
    blocks, and through one writer: every shard holds the same rows
    under the same rowids, and the branch counts agree."""
    monkeypatch.setattr(import_export, "_PROCESS_MIN_BYTES", 0)
    if chunk.endswith("blocks"):
        monkeypatch.setattr(import_export, "_NATIVE_CHUNK", 4096)
    src = _events_file(tmp_path, 8)
    parallel, counts = _import(tmp_path, "parallel", src, True)
    assert counts["python"] > 0 and counts["native"] > 0
    one, one_counts = _import(tmp_path, "one", src, False)
    assert counts == one_counts
    for a, b in zip(parallel.shards, one.shards):
        rows_a, _ = a.find_rows_since(1)
        assert rows_a and rows_a == b.find_rows_since(1)[0]


def test_a_failed_worker_import_rolls_back_every_shard(tmp_path,
                                                     monkeypatch):
    """A line no importer can take fails the import by worker processes
    with the one-process import's error, and no shard keeps a row."""
    monkeypatch.setattr(import_export, "_PROCESS_MIN_BYTES", 0)
    store = ShardedSQLiteEventStore(tmp_path / "s", 4)
    src = tmp_path / "bad.jsonl"
    lines = [json.dumps(Event(**x).to_json()) for x in _specs(11, 300)]
    lines[150] = '{"event": "rate", "entityType": "user"}'
    src.write_text("\n".join(lines) + "\n")
    with pytest.raises(EventValidationError):
        import_events(src, store, 1)
    one = ShardedSQLiteEventStore(tmp_path / "one", 4)
    one.import_shard_files = lambda: None
    with pytest.raises(EventValidationError):
        import_events(src, one, 1)
    assert store.max_rowid(1) == one.max_rowid(1) == 0
    assert store.high_water_cursor(1) == json.dumps(
        {str(k): 0 for k in range(4)}, separators=(",", ":"))


def test_a_failed_import_scope_rolls_back_every_shard(tmp_path):
    store = ShardedSQLiteEventStore(tmp_path / "s", 4)
    store.init_channel(1)
    store.insert_batch([Event(**x) for x in _specs(9, 40)], 1)
    before = [s.find_rows_since(1) for s in store.shards]
    with pytest.raises(RuntimeError, match="mid-import"):
        with store.bulk():
            store.insert_batch([Event(**x) for x in _specs(10, 80, 40)], 1)
            store.insert_raw_rows([
                (f"r{k}", "rate", "user", f"u{k}", "item", "i1",
                 '{"rating":1.0}', 0, "[]", None, 0) for k in range(50)], 1)
            raise RuntimeError("mid-import")
    assert [s.find_rows_since(1) for s in store.shards] == before
    store.insert_raw_rows([("z", "rate", "user", "u1", "item", "i1",
                            "{}", 0, "[]", None, 0)], 1)
    assert store.max_rowid(1) == 41
