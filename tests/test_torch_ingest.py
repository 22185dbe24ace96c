"""The port's ingest and training read against the JAX package's, on the
CPU.

The same seeded events go into one SQLite file that both packages open:
the port's native ``find_ratings`` must equal its own Python branch
(``find_columnar(minimal=True) -> to_ratings``) and the reference's
``find_ratings`` bit for bit, for explicit and implicit ratings and an
``entity_type`` filter.  Rows sqlite cannot scan natively, and stores
the native scan does not serve, take the Python branch and say why.  The
scan snapshot cache serves a repeat read and misses after a write.  The
JSON-lines import gives the reference's rows, and export then import
round-trips.
"""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as JaxSQLiteEventStore,
)
from predictionio_tpu.tools import import_export as jax_ie
from predictionio_tpu_torch.storage import Event, SQLiteEventStore
from predictionio_tpu_torch.tools import import_export as ie

T0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)


def _events(seed: int = 1, n: int = 800) -> list[Event]:
    """Rate events of users and shops over repeated (user, item) pairs at
    distinct times (dedup "last" has work), rates without a rating, and
    buy events."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        props = {"rating": float(rng.integers(1, 11)) * 0.5}
        if k % 53 == 0:
            props = {"note": "none"}
        out.append(Event(
            event="buy" if k % 9 == 0 else "rate",
            entity_type="shop" if k % 11 == 0 else "user",
            entity_id=f"u{int(rng.integers(0, 45))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(0, 70))}",
            properties=props, event_id=f"e{k:04d}",
            event_time=T0 + dt.timedelta(seconds=int(rng.integers(0, 10**6)))))
    return out


@pytest.fixture()
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("PIO_TPU_SCAN_CACHE", raising=False)
    es = SQLiteEventStore(tmp_path / "events.db")
    es.init_channel(1)
    es.insert_batch(_events(), 1)
    return es, tmp_path / "events.db"


def _same(a, b) -> None:
    assert list(a.users.ids) == list(b.users.ids)
    assert list(a.items.ids) == list(b.items.ids)
    for f in ("user_ix", "item_ix", "rating"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("kw", [
    dict(),
    dict(event_names=("rate", "buy"), rating_property=None, dedup="sum"),
    dict(entity_type="user", dedup="none"),
], ids=["explicit", "implicit", "entity_type"])
def test_native_read_equals_python_branch_and_reference(db, kw):
    es, path = db
    got = es.find_ratings(1, **kw)
    assert es.last_ratings_scan_path == "native"
    frame = es.find_columnar(
        1, event_names=list(kw.get("event_names", ("rate",))),
        float_property=kw.get("rating_property", "rating"), minimal=True,
        entity_type=kw.get("entity_type"))
    plain = frame.to_ratings(rating_property=kw.get("rating_property",
                                                    "rating"),
                             dedup=kw.get("dedup", "last"))
    jes = JaxSQLiteEventStore(path)
    want = jes.find_ratings(1, **kw)
    assert jes.last_ratings_scan_path == "native"
    assert len(got.rating) > 200
    _same(got, plain)
    _same(got, want)


def test_nan_property_takes_the_python_branch_and_says_why(db):
    es, path = db
    es.insert(Event(event="rate", entity_type="user", entity_id="u1",
                    target_entity_type="item", target_entity_id="i1",
                    properties={"rating": float("nan")}), 1)
    got = es.find_ratings(1)
    assert es.last_ratings_scan_path == "python"
    assert "JSON" in es.last_ratings_scan_reason
    jes = JaxSQLiteEventStore(path)
    _same(got, jes.find_ratings(1))
    assert jes.last_ratings_scan_path == "python"


def test_stores_the_native_scan_does_not_serve(db):
    es, _ = db
    mem = SQLiteEventStore()
    mem.init_channel(1)
    mem.insert_batch(_events(), 1)
    _same(mem.find_ratings(1), es.find_ratings(1))
    assert mem.last_ratings_scan_path == "python"
    assert mem.last_ratings_scan_reason == "in-memory db"
    with es.bulk():
        es.find_ratings(1)
    assert es.last_ratings_scan_reason == "open bulk scope"
    es.find_ratings(1, rating_property="rating.x")
    assert es.last_ratings_scan_reason == "property name 'rating.x'"


def test_scan_cache_hit_then_miss_after_a_write(db):
    es, _ = db
    first = es.find_ratings(1, cache=True)
    assert es.last_ratings_scan_path == "native"
    again = es.find_ratings(1, cache=True)
    assert es.last_ratings_scan_path == "cache"
    _same(again, first)
    es.insert(Event(event="rate", entity_type="user", entity_id="new",
                    target_entity_type="item", target_entity_id="i0",
                    properties={"rating": 5.0}), 1)
    after = es.find_ratings(1, cache=True)
    assert es.last_ratings_scan_path == "native"
    assert "new" in list(after.users.ids)


def test_columnar_scan_cache(db, tmp_path):
    es, _ = db
    kw = dict(event_names=["rate"], float_property="rating")
    first = es.find_columnar(1, cache=True, **kw)
    snaps = list((tmp_path / "home" / "scan_cache").glob("*.npz"))
    assert len(snaps) == 1
    again = es.find_columnar(1, cache=True, **kw)
    for f in ("entity_id", "target_entity_id", "event_time_ms", "value"):
        np.testing.assert_array_equal(getattr(again, f), getattr(first, f))
    assert again.value.tobytes() == first.value.tobytes()


def _jsonl(path, n: int = 300) -> None:
    """Event lines the native scanner takes whole, and lines it hands to
    the Python parser (an escape, tags); duplicate event ids (last line
    wins) and lines without an id."""
    with open(path, "w", encoding="utf-8") as f:
        for k in range(n):
            d = {"event": "rate", "entityType": "user",
                 "entityId": f"u{k % 17}", "targetEntityType": "item",
                 "targetEntityId": f"i{k % 23}",
                 "properties": {"rating": k % 5 + 1},
                 "eventTime": f"2022-02-{k % 28 + 1:02d}T03:04:05.{k:03d}Z",
                 "creationTime": "2022-03-01T00:00:00.000Z"}
            if k % 3:
                d["eventId"] = f"id{k % 250}"
            if k % 41 == 0:
                d["entityId"] = "café"
            if k % 43 == 0:
                d["tags"] = ["t"]
            f.write(json.dumps(d) + "\n")


def _rows(es, with_ids: bool = True) -> list:
    rows = [r if with_ids else r[1:] for r in es.iter_raw_rows(1)]
    return sorted(rows, key=repr)


def test_import_gives_the_references_rows(tmp_path):
    src = tmp_path / "events.jsonl"
    _jsonl(src)
    es = SQLiteEventStore(tmp_path / "port.db")
    jes = JaxSQLiteEventStore(tmp_path / "jax.db")
    counts = {}
    n = ie.import_events(src, es, 1, counts=counts)
    assert n == jax_ie.import_events(src, jes, 1) == 300
    assert counts["python"] > 0 and counts["native"] > 0
    assert counts["native"] + counts["python"] == 300
    # fresh ids differ between runs; everything else is equal
    assert _rows(es, False) == _rows(jes, False)
    with_id = [k % 250 for k in range(300) if k % 3]
    assert len(_rows(es)) == len(set(with_id)) + 300 - len(with_id)


def test_export_then_import_round_trips(tmp_path):
    src = tmp_path / "events.jsonl"
    _jsonl(src)
    es = SQLiteEventStore(tmp_path / "a.db")
    ie.import_events(src, es, 1)
    out = tmp_path / "out.jsonl"
    n = ie.export_events(out, es, 1)
    assert n == len(_rows(es))
    jout = tmp_path / "jax.jsonl"
    jax_ie.export_events(jout, JaxSQLiteEventStore(tmp_path / "a.db"), 1)
    assert out.read_text(encoding="utf-8") == jout.read_text(
        encoding="utf-8")
    back = SQLiteEventStore(tmp_path / "b.db")
    assert ie.import_events(out, back, 1) == n
    # the wire format (Event.to_json) carries no tags
    assert _rows(back) == [r[:8] + ("[]",) + r[9:] for r in _rows(es)]


@pytest.mark.parametrize("name", ["events.npz", "events.parquet"])
def test_columnar_and_parquet_files_are_not_ported(tmp_path, name):
    # ported since: an empty app exports and imports back as the
    # reference's does, and a truncated file fails with its error
    got = {}
    for kind, mod, cls in (("port", ie, SQLiteEventStore),
                           ("jax", jax_ie, JaxSQLiteEventStore)):
        es = cls(tmp_path / f"{kind}.db")
        path = tmp_path / f"{kind}-{name}"
        out = [mod.export_events(path, es, 1),
               mod.import_events(path, es, 2)]
        path.write_bytes(b"PK\x03\x04" if name.endswith(".npz")
                         else b"PAR1")
        with pytest.raises(Exception) as e:
            mod.import_events(path, es, 1)
        out.append(type(e.value).__name__)
        got[kind] = out
    assert got["port"] == got["jax"]
    assert got["port"][:2] == [0, 0]


def test_raw_rows_and_ttl_purge_match_reference(tmp_path):
    rows = [(f"r{k}", "rate", "user", f"u{k}", "item", "i1",
             '{"rating":2}', 1_000 * k, "[]", None, 5_000)
            for k in range(10)]
    es = SQLiteEventStore(tmp_path / "p.db")
    jes = JaxSQLiteEventStore(tmp_path / "j.db")
    for store in (es, jes):
        store.init_channel(1)
        store.insert_raw_rows(rows, 1)
    assert es.purge_older_than(4_000, 1) == jes.purge_older_than(4_000, 1) == 4
    assert _rows(es) == _rows(jes) == sorted(rows[4:], key=repr)
