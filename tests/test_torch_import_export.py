"""The port's ``.npz`` columnar, Parquet and MovieLens-CSV formats against
the JAX package's, on the CPU.

The same JSON-lines events (every event with its own id and times) go
into a reference store and a port store, single-file and 4-shard.  Both
packages' ``.npz`` exports must be equal column by column and their
Parquet exports equal ``pyarrow`` tables; each package imports the
other's files, and ``find`` then gives equal events.  The same
MovieLens ``::`` file and a ``,``-delimited file with a header give
equal entities, targets and properties (event ids and times are random
or the import's time, so they are not compared).  A hand-made ``.npz``
of rows the column-wise path does not take, and the validation errors,
give the reference's events and the reference's exception, class and
message.  No tolerance: every comparison is exact.
"""

import datetime as dt
import json

import numpy as np
import pyarrow.parquet as pq
import pytest

from predictionio_tpu.storage.event import (
    EventValidationError as JaxEventValidationError,
)
from predictionio_tpu.storage.sharded_events import (
    ShardedSQLiteEventStore as JaxSharded,
)
from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as JaxSQLite,
)
from predictionio_tpu.tools import import_export as jax_ie
from predictionio_tpu_torch.storage import ShardedSQLiteEventStore
from predictionio_tpu_torch.storage.event import EventValidationError
from predictionio_tpu_torch.storage.sqlite_events import SQLiteEventStore
from predictionio_tpu_torch.tools import import_export as port_ie

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
APP = 1


def _dir(p):
    p.mkdir(parents=True, exist_ok=True)
    return p


STORES = {
    "single": {"jax": lambda p: JaxSQLite(_dir(p) / "events.db"),
               "port": lambda p: SQLiteEventStore(_dir(p) / "events.db")},
    "sharded": {"jax": lambda p: JaxSharded(p / "shards", 4),
                "port": lambda p: ShardedSQLiteEventStore(p / "shards", 4)},
}
MODULES = {"jax": jax_ie, "port": port_ie}


def _iso(ms: int) -> str:
    return (T0 + dt.timedelta(milliseconds=ms)).isoformat(
        timespec="milliseconds").replace("+00:00", "Z")


def _event_lines(n: int = 900, seed: int = 0) -> list[dict]:
    """Rate events, views without properties, item ``$set`` events,
    feedback events with a ``prId``, tagged events and non-ASCII ids;
    each with its own id, event time and creation time."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = k % 9
        d = {"eventId": f"e{k:05d}",
             "eventTime": _iso(int(rng.integers(0, 4 * n))),
             "creationTime": _iso(10 * n + k)}
        if kind < 5:
            d.update(event="rate", entityType="user",
                     entityId=f"u{int(rng.integers(0, 40))}",
                     targetEntityType="item",
                     targetEntityId=f"i{int(rng.integers(0, 25))}",
                     properties={"rating": float(rng.integers(1, 11)) / 2})
        elif kind == 5:
            d.update(event="view", entityType="user", entityId=f"u{k % 7}",
                     targetEntityType="item", targetEntityId="ítem-√")
        elif kind == 6:
            d.update(event="$set", entityType="item", entityId=f"i{k % 25}",
                     properties={"categories": ["a", "b"][: 1 + k % 2],
                                 "price": 1.25 * k})
        elif kind == 7:
            d.update(event="predict", entityType="pio_pr",
                     entityId=f"pr{k}", prId=f"pr{k}",
                     properties={"query": {"user": "u1", "num": 3}})
        else:
            d.update(event="buy", entityType="user", entityId="ユーザー",
                     tags=["t1", "t2"], properties={"n": k})
        out.append(d)
    return out


@pytest.fixture(params=sorted(STORES))
def filled(request, tmp_path):
    """Per package, a store of ``request.param``'s kind holding the same
    events, imported from one JSON-lines file by the package's own
    ``import_events``."""
    src = tmp_path / "events.jsonl"
    src.write_text("".join(json.dumps(d) + "\n" for d in _event_lines()),
                   encoding="utf-8")
    stores = {}
    for name, make in STORES[request.param].items():
        stores[name] = make(tmp_path / name)
        MODULES[name].import_events(src, stores[name], APP)
    yield request.param, stores, tmp_path
    for s in stores.values():
        s.close()


def _events(store, app_id: int = APP) -> list[dict]:
    """Every stored event's wire JSON with its tags, by event id."""
    out = [dict(e.to_json(), tags=list(e.tags))
           for e in store.find(app_id=app_id)]
    return sorted(out, key=lambda d: d["eventId"])


def test_npz_exports_are_equal_column_by_column(filled):
    _, stores, tmp = filled
    files = {}
    for name, store in stores.items():
        n = MODULES[name].export_events(tmp / f"{name}-out", store, APP,
                                        fmt="columnar")
        assert n == 900
        files[name] = np.load(port_ie.columnar_path(tmp / f"{name}-out"))
    assert sorted(files["port"].files) == sorted(files["jax"].files)
    for col in files["jax"].files:
        np.testing.assert_array_equal(files["port"][col], files["jax"][col])
        assert files["port"][col].dtype == files["jax"][col].dtype


def test_parquet_exports_give_equal_tables(filled):
    _, stores, tmp = filled
    tables = {}
    for name, store in stores.items():
        path = tmp / f"{name}.parquet"
        assert MODULES[name].export_events(path, store, APP) == 900
        tables[name] = pq.read_table(path)
    assert tables["port"].schema == tables["jax"].schema
    assert tables["port"].equals(tables["jax"])


@pytest.mark.parametrize("ext", [".npz", ".parquet"])
def test_each_package_imports_the_others_files(filled, ext):
    kind, stores, tmp = filled
    files = {}
    for name, store in stores.items():
        files[name] = tmp / f"{name}-export{ext}"
        MODULES[name].export_events(files[name], store, APP)
    got = {}
    for name, other in (("port", "jax"), ("jax", "port")):
        store = STORES[kind][name](tmp / f"{name}-reimport")
        try:
            assert MODULES[name].import_events(files[other], store, 7) == 900
            got[name] = _events(store, 7)
        finally:
            store.close()
    assert got["port"] == got["jax"]
    want = _events(stores["jax"])
    if ext == ".npz":  # the columnar format carries no tags
        want = [dict(d, tags=[]) for d in want]
    assert got["port"] == want


def test_only_a_file_at_the_cutoff_goes_to_the_workers(tmp_path,
                                                      monkeypatch):
    """A JSON-lines file smaller than ``_PROCESS_MIN_BYTES`` goes into
    the 4-shard store in this process, one of that size through a worker
    process a shard; both stores give the reference's events."""
    from predictionio_tpu_torch.tools import shard_import

    src = tmp_path / "events.jsonl"
    src.write_text("".join(json.dumps(d) + "\n" for d in _event_lines()),
                   encoding="utf-8")
    jax = STORES["sharded"]["jax"](tmp_path / "jax")
    jax_ie.import_events(src, jax, APP)
    want = _events(jax)
    jax.close()
    sent = []
    real = shard_import.import_by_shard
    monkeypatch.setattr(shard_import, "import_by_shard",
                        lambda *a, **kw: sent.append(a[0]) or real(*a, **kw))
    size = src.stat().st_size
    for name, cutoff in (("below", size + 1), ("at", size)):
        monkeypatch.setattr(port_ie, "_PROCESS_MIN_BYTES", cutoff)
        store = STORES["sharded"]["port"](tmp_path / name)
        try:
            assert port_ie.import_events(src, store, APP) == 900
            assert _events(store) == want
        finally:
            store.close()
    assert sent == [src]


def _odd_npz(path) -> None:
    """Rows the column-wise path leaves to ``Event.from_json``: a time
    with an offset, missing times and ids, a target type without its
    id (the last row, which the reference refuses)."""
    rows = [
        ("rate", "user", "u1", "item", "i1", "2024-03-01T10:00:00+02:00",
         "x1", "", "", '{"rating":4.0}'),
        ("view", "user", "u2", "", "", "", "", "pr9", "", ""),
        ("$set", "item", "i3", "", "", "2024-03-01T00:00:00.000Z", "x3",
         "", "2024-03-02T00:00:00.000Z", '{"a":[1,2]}'),
        ("rate", "user", "u4", "item", "", "2024-03-01T00:00:00.000Z",
         "x4", "", "", '{"rating":1.0}'),
    ]
    cols = list(zip(*rows))
    names = (*port_ie._COLUMNS, "properties")
    np.savez_compressed(path, **{c: np.asarray(v, dtype=np.str_)
                                 for c, v in zip(names, cols)})


def test_odd_npz_rows_import_and_fail_as_the_reference(tmp_path,
                                                       monkeypatch):
    # three one-row batches land before the fourth raises
    monkeypatch.setattr(jax_ie, "_BATCH", 1)
    monkeypatch.setattr(port_ie, "_BATCH", 1)
    _odd_npz(tmp_path / "odd.npz")
    got, errs = {}, {}
    for name in ("jax", "port"):
        store = STORES["single"][name](tmp_path / name)
        try:
            with pytest.raises(ValueError) as e:
                MODULES[name].import_events(tmp_path / "odd.npz", store, APP)
            errs[name] = (type(e.value).__name__, str(e.value))
            got[name] = _events(store)
        finally:
            store.close()
    assert errs["port"] == errs["jax"] == (
        "EventValidationError",
        "targetEntityType and targetEntityId must be specified together.")
    # a missing id or time is the import's: random, or the clock's
    for d in (*got["port"], *got["jax"]):
        if d["event"] != "$set":
            del d["creationTime"]
        if d["event"] == "view":
            del d["eventId"], d["eventTime"]
    assert got["port"] == got["jax"]
    assert sorted(d["event"] for d in got["port"]) == ["$set", "rate", "view"]


def _ratings_file(path, delimiter: str, header: bool) -> None:
    rng = np.random.default_rng(3)
    lines = ["userId,movieId,rating,timestamp"] if header else []
    for k in range(700):
        lines.append(delimiter.join((
            str(int(rng.integers(1, 60))), str(int(rng.integers(1, 90))),
            str(float(rng.integers(1, 11)) / 2), str(978300760 + k))))
    path.write_text("\n".join(lines) + "\n\n")


def _triples(store) -> list:
    return sorted((e.entity_type, e.entity_id, e.target_entity_type,
                   e.target_entity_id, e.event,
                   json.dumps(e.properties.to_json()))
                  for e in store.find(app_id=APP))


@pytest.mark.parametrize("delimiter,header", [("::", False), (",", True)])
def test_ratings_csv_imports_equal_events(tmp_path, delimiter, header):
    src = tmp_path / "ratings.dat"
    _ratings_file(src, delimiter, header)
    for kind in STORES:
        got = {}
        for name in ("jax", "port"):
            store = STORES[kind][name](tmp_path / kind / name)
            try:
                n = MODULES[name].import_ratings_csv(
                    src, store, APP, delimiter=delimiter, has_header=header)
                assert n == 700
                got[name] = _triples(store)
                events = list(store.find(app_id=APP))
                assert len({e.event_id for e in events}) == 700
                assert len({e.creation_time for e in events}) == 1
            finally:
                store.close()
        assert got["port"] == got["jax"]
        assert {t[4] for t in got["port"]} == {"rate"}


def test_csv_and_npz_errors_are_the_references(tmp_path):
    src = tmp_path / "bad.dat"
    bad = {"empty user": "::7::4.0\n", "empty item": "3::::4.0\n"}
    got = {}
    for kind, name, errcls in (
            (k, n, c) for k in STORES
            for n, c in (("jax", JaxEventValidationError),
                         ("port", EventValidationError))):
        out = []
        store = STORES[kind][name](tmp_path / kind / name)
        try:
            for text in bad.values():
                src.write_text("1::2::3.0\n" + text)
                with pytest.raises(errcls) as e:
                    MODULES[name].import_ratings_csv(src, store, APP)
                out.append(str(e.value))
            with pytest.raises(errcls) as e:
                MODULES[name].import_ratings_csv(src, store, APP,
                                                 event="$bogus")
            out.append(str(e.value))
            fields = {"event": "v", "entityType": "pio_x", "entityId": "v"}
            np.savez(tmp_path / f"{name}.npz", **{
                c: np.asarray([fields.get(c, "")])
                for c in (*port_ie._COLUMNS, "properties")})
            with pytest.raises(errcls) as e:
                MODULES[name].import_events(tmp_path / f"{name}.npz",
                                            store, APP)
            out.append(str(e.value))
            # the bad CSV rows rolled back with their bulk scope
            out.append(sum(1 for _ in store.find(app_id=APP)))
        finally:
            store.close()
        got[kind, name] = out
    for kind in STORES:
        assert got[kind, "port"] == got[kind, "jax"] == got["single", "jax"]
    assert got["single", "port"][:2] == ["entityId must not be empty string.",
                               "targetEntityId must not be empty string."]
    assert got["single", "port"][-1] == 0
