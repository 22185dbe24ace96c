"""The port's entity-hash sharded event store against the JAX package's,
on the CPU.

The same seeded events go into both packages' sharded stores; routing
(``_shard_ix``), the marker, the
concurrent ``find_ratings`` (codes, ratings and both dictionaries, bit
for bit), the other reads, the explicit-id drift, ownership and the
JSON-lines import give the reference's results, and either package
reads a sharded store the other wrote.
"""

import datetime as dt
import json
import threading

import numpy as np
import pytest

from predictionio_tpu.storage import NO_TARGET as JAX_NO_TARGET
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.sharded_events import (
    ShardedSQLiteEventStore as JaxSharded,
    _shard_ix as jax_shard_ix,
)
from predictionio_tpu.tools.import_export import (
    import_events as jax_import_events,
)
from predictionio_tpu_torch.storage import (
    NO_TARGET,
    Event,
    ShardUnavailableError,
    ShardedSQLiteEventStore,
    Storage,
    StorageError,
)
from predictionio_tpu_torch.storage.sharded_events import _shard_ix
from predictionio_tpu_torch.tools.import_export import import_events

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
N_SHARDS = 3


def _random_ids(rng, n: int) -> list[str]:
    """Ids of 1-12 code points: ASCII, Latin, CJK, emoji and lone
    surrogates (which only ``surrogatepass`` can encode)."""
    ranges = [(0x20, 0x7F), (0xA0, 0x2FF), (0x4E00, 0x9FFF),
              (0x1F300, 0x1F64F), (0xD800, 0xDFFF)]
    out = []
    for _ in range(n):
        chars = []
        for _ in range(int(rng.integers(1, 13))):
            lo, hi = ranges[int(rng.integers(0, len(ranges)))]
            chars.append(chr(int(rng.integers(lo, hi))))
        out.append("".join(chars))
    return out


def test_routing_equals_the_references_for_random_ids():
    rng = np.random.default_rng(7)
    ids = _random_ids(rng, 10_000)
    types = [("user", "item", "ユーザー", "\ud800x")[int(k)]
             for k in rng.integers(0, 4, len(ids))]
    assert any("\ud800" <= c <= "\udfff" for s in ids for c in s)
    for n in (1, 3, 4, 7):
        want = [jax_shard_ix(t, e, n) for t, e in zip(types, ids)]
        assert [_shard_ix(t, e, n) for t, e in zip(types, ids)] == want


def _event_specs(seed: int = 0, n: int = 600) -> list[dict]:
    """Rate events with repeated (user, item) pairs (some at one time,
    some later), rates without a rating, rates by another entity type,
    views and item ``$set`` events; every event has its own id."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.random()
        spec = dict(event_id=f"e{k:05d}",
                    event_time=T0 + dt.timedelta(
                        milliseconds=int(rng.integers(0, 4 * n))))
        if kind < 0.75:
            props = {"rating": float(rng.integers(1, 11) * 0.5)}
            if rng.random() < 0.04:
                props = {"note": "no rating"}
            spec.update(event="rate",
                        entity_type="admin" if rng.random() < 0.05
                        else "user",
                        entity_id=f"u{rng.integers(0, 40)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(0, 25)}",
                        properties=props)
        elif kind < 0.85:
            spec.update(event="view", entity_type="user",
                        entity_id=f"u{rng.integers(0, 40)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(0, 25)}")
        else:
            spec.update(event="$set", entity_type="item",
                        entity_id=f"i{rng.integers(0, 25)}",
                        properties={"categories": ["c1"]})
        out.append(spec)
    return out


def _pair(tmp_path, specs=None, n_shards=N_SHARDS):
    """(port store, reference store) over their own directories, each
    filled with the same events in one bulk scope."""
    stores = []
    for cls, ev, name in ((ShardedSQLiteEventStore, Event, "port"),
                          (JaxSharded, JaxEvent, "jax")):
        s = cls(tmp_path / name, n_shards)
        s.init_channel(1)
        if specs:
            with s.bulk():
                s.insert_batch([ev(**x) for x in specs], 1)
        stores.append(s)
    return stores


def _same_ratings(a, b) -> None:
    assert list(a.users.ids) == list(b.users.ids)
    assert list(a.items.ids) == list(b.items.ids)
    for f in ("user_ix", "item_ix", "rating"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_marker_is_created_once_and_a_count_mismatch_is_refused(tmp_path):
    ShardedSQLiteEventStore(tmp_path / "s", 4).close()
    assert json.loads((tmp_path / "s" / "shards.json").read_text()) == {
        "n_shards": 4}
    assert sorted(p.name for p in (tmp_path / "s").glob("shard-*.db")) == [
        f"shard-{i}.db" for i in range(4)]
    # either package opens the other's directory at its count only
    JaxSharded(tmp_path / "s", 4).close()
    for cls in (ShardedSQLiteEventStore, JaxSharded):
        with pytest.raises(ValueError, match="created with 4 shards"):
            cls(tmp_path / "s", 3)
    with pytest.raises(ValueError, match=">= 1"):
        ShardedSQLiteEventStore(tmp_path / "t", 0)
    # the registry's source type: PATH a directory, SHARDS the count
    env = {"PIO_TPU_HOME": str(tmp_path),
           "PIO_STORAGE_SOURCES_SH_TYPE": "sqlite-sharded",
           "PIO_STORAGE_SOURCES_SH_PATH": str(tmp_path / "s"),
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH"}
    es = Storage(env).get_event_store()
    assert isinstance(es, ShardedSQLiteEventStore) and es.n_shards == 4
    for shards, match in (("3", "created with 4"), ("two", "invalid"),
                          ("0", ">= 1")):
        with pytest.raises(StorageError, match=match):
            Storage(dict(env, PIO_STORAGE_SOURCES_SH_SHARDS=shards)
                    ).get_event_store()
    default = Storage({**env, "PIO_STORAGE_SOURCES_SH_PATH": ""})
    assert default.get_event_store().n_shards == 4
    assert (tmp_path / "eventdata-shards" / "shards.json").exists()


def test_racing_first_opens_have_one_winner(tmp_path):
    for trial in range(8):
        path = tmp_path / f"race{trial}"
        start = threading.Barrier(2)
        outcome: dict[int, object] = {}

        def open_with(n: int) -> None:
            start.wait(timeout=10)
            try:
                ShardedSQLiteEventStore(path, n).close()
                outcome[n] = "opened"
            except ValueError as e:
                outcome[n] = e

        threads = [threading.Thread(target=open_with, args=(n,))
                   for n in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        winners = [n for n, o in outcome.items() if o == "opened"]
        assert len(winners) == 1, outcome
        stamped = json.loads((path / "shards.json").read_text())["n_shards"]
        assert winners == [stamped]


def test_find_ratings_equals_the_references_bit_for_bit(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    port, jax = _pair(tmp_path, _event_specs())
    # explicit and implicit reads; the scan cache's second read takes
    # every shard's snapshot
    for rating_property, cache, path in (
            ("rating", False, "native"), (None, False, "native"),
            ("rating", True, "native"), ("rating", True, "cache")):
        got = port.find_ratings(1, rating_property=rating_property,
                                entity_type="user", cache=cache)
        want = jax.find_ratings(1, rating_property=rating_property,
                                entity_type="user")
        _same_ratings(got, want)
        assert port.last_ratings_scan_path == path
        assert len(port.last_ratings_shard_seconds) == N_SHARDS
        assert port.last_ratings_merge_seconds >= 0
        # the order is the shards', not the single store's: shard by
        # shard
        shard = [_shard_ix("user", u, N_SHARDS) for u in got.users.ids]
        assert np.all(np.diff(np.asarray(shard)[got.user_ix]) >= 0)
    _same_ratings(port.find_ratings(1, dedup="sum"),
                  jax.find_ratings(1, dedup="sum"))


def test_the_shards_are_scanned_at_once(tmp_path, monkeypatch):
    """Every shard's native scan must be running before any returns: a
    barrier of N_SHARDS parties inside the scan breaks (and the read
    raises) if the shards are scanned one after another."""
    import predictionio_tpu_torch.native as native

    port, _ = _pair(tmp_path, _event_specs(1, 300))
    inside = threading.Barrier(N_SHARDS, timeout=20)
    real = native.scan_ratings_sqlite

    def scan(*args, **kw):
        inside.wait()
        return real(*args, **kw)

    monkeypatch.setattr(native, "scan_ratings_sqlite", scan)
    got = port.find_ratings(1)
    assert port.last_ratings_scan_path == "native" and len(got.rating)


def test_other_reads_match_the_reference(tmp_path):
    port, jax = _pair(tmp_path, _event_specs(2))

    def flat(events):
        return [(e.event_id, e.event, e.entity_id, e.target_entity_id,
                 e.properties.to_json(), e.event_time) for e in events]

    for kw in (dict(), dict(limit=7), dict(reversed=True, limit=11),
               dict(entity_type="user", entity_id="u3"),
               dict(event_names=["view"], target_entity_type=NO_TARGET),
               dict(start_time=T0 + dt.timedelta(milliseconds=500),
                    until_time=T0 + dt.timedelta(milliseconds=900))):
        jkw = {k: JAX_NO_TARGET if v is NO_TARGET else v
               for k, v in kw.items()}
        assert flat(port.find(1, **kw)) == flat(jax.find(1, **jkw)), kw
    for kw in (dict(event_names=["rate"], float_property="rating"),
               dict(entity_type="user", entity_id="u5"),
               dict(minimal=True, event_names=["rate", "view"])):
        a, b = port.find_columnar(1, **kw), jax.find_columnar(1, **kw)
        for f in ("event", "entity_id", "target_entity_id",
                  "event_time_ms", "value"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.array_equal(x, y, equal_nan=y.dtype != object), f
    assert flat([port.get("e00010", 1)]) == flat([jax.get("e00010", 1)])
    assert port.get("missing", 1) is None and jax.get("missing", 1) is None
    assert port.delete("e00010", 1) is jax.delete("e00010", 1) is True
    assert port.delete("e00010", 1) is jax.delete("e00010", 1) is False
    ids = [f"e{k:05d}" for k in range(0, 600, 7)] + ["missing"]
    assert port.delete_batch(ids, 1) == jax.delete_batch(ids, 1) > 0
    assert flat(port.find(1)) == flat(jax.find(1))


def test_an_explicit_id_reused_across_entities_drifts_as_documented(
        tmp_path):
    """Re-posting an explicit event id under an entity of another shard
    leaves both copies (the reference's documented drift); ``delete``
    removes every copy."""
    a, b = "u0", next(f"u{k}" for k in range(1, 99)
                      if _shard_ix("user", f"u{k}", N_SHARDS)
                      != _shard_ix("user", "u0", N_SHARDS))
    port, jax = _pair(tmp_path)
    for s, ev in ((port, Event), (jax, JaxEvent)):
        for user in (a, b):
            s.insert(ev(event_id="dup", event="rate", entity_type="user",
                        entity_id=user, target_entity_type="item",
                        target_entity_id="i1",
                        properties={"rating": 3.0}, event_time=T0), 1)
    assert [e.entity_id for e in port.find(1)] == [
        e.entity_id for e in jax.find(1)] and len(list(port.find(1))) == 2
    assert port.get("dup", 1).entity_id == jax.get("dup", 1).entity_id
    assert port.delete("dup", 1) and jax.delete("dup", 1)
    assert list(port.find(1)) == [] == list(jax.find(1))


def test_owned_shards_refuse_foreign_writes(tmp_path):
    port, _ = _pair(tmp_path)
    users = {_shard_ix("user", f"u{k}", N_SHARDS): f"u{k}"
             for k in range(40)}
    port.set_owned_shards([0])

    def rate(user):
        return Event(event="rate", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id="i1",
                     properties={"rating": 1.0}, event_time=T0)

    port.insert(rate(users[0]), 1)
    with pytest.raises(ShardUnavailableError, match="not owned") as e:
        port.insert(rate(users[2]), 1)
    assert e.value.shard == 2
    # a batch touching a foreign shard writes nothing (all or nothing)
    with pytest.raises(ShardUnavailableError):
        port.insert_batch([rate(users[0]), rate(users[1])], 1)
    row = ("x", "rate", "user", users[1], "item", "i", "{}", 0, "[]",
           None, 0)
    with pytest.raises(ShardUnavailableError):
        port.insert_raw_rows([row], 1)
    assert [e.entity_id for e in port.find(1)] == [users[0]]
    with pytest.raises(ValueError, match="out of range"):
        port.set_owned_shards([3])
    port.set_owned_shards(None)
    port.insert(rate(users[2]), 1)
    assert len(list(port.find(1))) == 2


def test_import_into_a_sharded_store_gives_the_references_rows(tmp_path):
    specs = _event_specs(3, 400)
    src = tmp_path / "events.jsonl"
    with open(src, "w", encoding="utf-8") as f:
        for s in specs:
            f.write(json.dumps(Event(**s).to_json()) + "\n")
    port, jax = _pair(tmp_path)
    counts = {}
    assert import_events(src, port, 1, counts=counts) == len(specs)
    assert counts == {"native": len(specs), "python": 0}
    assert jax_import_events(src, jax, 1) == len(specs)
    for ps, js in zip(port.shards, jax.shards):
        rows = list(ps.iter_raw_rows(1))
        assert rows and rows == list(js.iter_raw_rows(1))
    _same_ratings(port.find_ratings(1), jax.find_ratings(1))


def test_each_package_reads_the_others_sharded_store(tmp_path):
    specs = _event_specs(4, 300)
    port, jax = _pair(tmp_path, specs)
    for cls, other in ((ShardedSQLiteEventStore, "jax"),
                       (JaxSharded, "port")):
        reopened = cls(tmp_path / other, N_SHARDS)
        _same_ratings(reopened.find_ratings(1), port.find_ratings(1))
        reopened.close()


def test_maintenance_is_scoped_to_owned_shards(tmp_path, monkeypatch):
    port, jax = _pair(tmp_path, _event_specs(5, 300))
    cutoff = int((T0 + dt.timedelta(milliseconds=600)).timestamp() * 1000)
    for s in (port, jax):
        s.set_owned_shards([1])
    assert port.purge_older_than(cutoff, 1) == jax.purge_older_than(
        cutoff, 1) > 0
    left = [sum(1 for _ in s.iter_raw_rows(1)) for s in port.shards]
    assert left == [sum(1 for _ in s.iter_raw_rows(1)) for s in jax.shards]
    compacted = []
    for i, shard in enumerate(port.shards):
        monkeypatch.setattr(shard, "compact",
                            lambda i=i: compacted.append(i))
    port.compact()
    assert compacted == [1]
    for s in (port, jax):
        s.set_owned_shards(None)
    assert port.purge_older_than(cutoff, 1) == jax.purge_older_than(
        cutoff, 1) > 0


def test_incremental_scans_wait_for_their_item(tmp_path):
    """The incremental scans, once a wait for their ROADMAP item, now
    answer like the reference's on the same store: rows, shard-vector
    cursors, the high-water mark and the lag."""
    port, jax = _pair(tmp_path, _event_specs(6, 300))
    for cursor in (0, port.high_water_cursor(1)):
        for method in ("find_rows_since", "find_since"):
            got = getattr(port, method)(1, cursor=cursor)
            want = getattr(jax, method)(1, cursor=cursor)
            # every column but the creation time, which is each insert's
            if method == "find_since":
                got = ([(r, {**e.to_json(), "creationTime": None})
                        for r, e in got[0]], got[1])
                want = ([(r, {**e.to_json(), "creationTime": None})
                         for r, e in want[0]], want[1])
            else:
                got = ([r[:-1] for r in got[0]], got[1])
                want = ([r[:-1] for r in want[0]], want[1])
            assert got == want
        assert port.cursor_lag(1, cursor=cursor) == jax.cursor_lag(
            1, cursor=cursor)
    assert port.max_rowid(1) == jax.max_rowid(1) > 0
    assert port.high_water_cursor(1) == jax.high_water_cursor(1)


def test_a_worker_that_fails_rolls_the_import_back(tmp_path, monkeypatch):
    """The JSON-lines import by worker processes: a shard file a worker
    cannot open fails the import with that shard named, and the other
    shards keep no row."""
    from predictionio_tpu_torch.tools import import_export

    monkeypatch.setattr(import_export, "_PROCESS_MIN_BYTES", 0)
    specs = _event_specs(7, 200)
    src = tmp_path / "events.jsonl"
    with open(src, "w", encoding="utf-8") as f:
        for s in specs:
            f.write(json.dumps(Event(**s).to_json()) + "\n")
    port = ShardedSQLiteEventStore(tmp_path / "port", N_SHARDS)
    port.init_channel(1)
    for f in (tmp_path / "port").glob("shard-1.db*"):
        f.unlink()
    (tmp_path / "port" / "shard-1.db").mkdir()
    with pytest.raises(RuntimeError, match="the import of shard 1 failed"):
        import_events(src, port, 1)
    for k in (0, 2):
        assert port.shards[k].max_rowid(1) == 0
