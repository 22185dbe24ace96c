"""The port's native host runtime against the JAX package's, on the CPU.

Both packages build the same repo-root C++ sources (``native/*.cpp``),
each into its own library: the counting sort must equal the reference's
and the NumPy plain version bit for bit (stable, empty, out of range),
the SQLite ratings scan and the JSON-lines scan must return the
reference's arrays on the same database and bytes, concurrent builds
compile once, a failing compiler raises instead of falling back, and the
device staging refuses a COO past the int32 offset range as the
reference does.
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu import native as jax_native
from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu_torch import native
from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
from predictionio_tpu_torch.storage import Event, SQLiteEventStore

ROOT = Path(__file__).resolve().parents[1]


def _coo(seed: int, n: int, n_rows: int, n_cols: int):
    rng = np.random.default_rng(seed)
    # few rows, many ratings each: stability shows on every row
    return (rng.integers(0, n_rows, n).astype(np.int32),
            rng.integers(0, n_cols, n).astype(np.int32),
            rng.random(n).astype(np.float32))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sort_equals_reference_and_numpy_bitwise():
    r, c, v = _coo(0, 50_000, 97, 1000)
    got = native.sort_coo_by_row(r, c, v, 100)
    _same(got, native.sort_coo_by_row_numpy(r, c, v, 100))
    assert jax_native.native_available()
    _same(got, jax_native.sort_coo_by_row(r, c, v, 100))
    # stable: each row keeps its ratings in input order
    c_sorted, _, counts, starts = got
    for row in (0, 42, 96):
        np.testing.assert_array_equal(
            c_sorted[starts[row]:starts[row + 1]], c[r == row])
    assert counts[97:].sum() == 0


def test_sort_empty_input():
    e32 = np.empty(0, np.int32)
    got = native.sort_coo_by_row(e32, e32, np.empty(0, np.float32), 5)
    _same(got, native.sort_coo_by_row_numpy(
        e32, e32, np.empty(0, np.float32), 5))
    assert got[3].tolist() == [0] * 6


@pytest.mark.parametrize("bad", [-1, 10])
def test_sort_rejects_row_ids_out_of_range(bad):
    r = np.array([0, bad, 3], np.int32)
    c = np.zeros(3, np.int32)
    v = np.ones(3, np.float32)
    for fn in (native.sort_coo_by_row, native.sort_coo_by_row_numpy,
               jax_native.sort_coo_by_row):
        with pytest.raises(ValueError, match=r"row ids must be in \[0, 10\)"):
            fn(r, c, v, 10)


@pytest.fixture()
def rated_db(tmp_path):
    """A SQLite event store with rate events (two entity types, repeated
    pairs, one rate without a rating) and view events."""
    es = SQLiteEventStore(tmp_path / "events.db")
    es.init_channel(1)
    rng = np.random.default_rng(5)
    evs = []
    for k in range(600):
        props = {} if k % 97 == 0 else {"rating": float(rng.integers(1, 11)) / 2}
        evs.append(Event(
            event="rate" if k % 5 else "view",
            entity_type="user" if k % 7 else "shop",
            entity_id=f"u{int(rng.integers(0, 40))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(0, 60))}",
            properties=props, event_id=f"e{k}"))
    es.insert_batch(evs, 1)
    return str(tmp_path / "events.db")


@pytest.mark.parametrize("has_value", [True, False])
def test_ratings_scan_equals_reference(rated_db, has_value):
    value = ", json_extract(properties, '$.rating')" if has_value else ""
    sql = (f"SELECT entity_id, target_entity_id, event_time{value} "
           "FROM events_1 WHERE event IN (?,?) AND entity_type = ?3")
    binds = ["rate", "view", "user"]
    got = native.scan_ratings_sqlite(rated_db, sql, binds, has_value)
    want = jax_native.scan_ratings_sqlite(rated_db, sql, binds, has_value)
    assert len(got[0]) > 300
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ratings_scan_error_raises_with_sqlite_message(rated_db):
    es = SQLiteEventStore(rated_db)
    es.insert(Event(event="rate", entity_type="user", entity_id="u1",
                    target_entity_type="item", target_entity_id="i1",
                    properties={"rating": float("nan")}), 1)
    sql = ("SELECT entity_id, target_entity_id, event_time, "
           "json_extract(properties, '$.rating') FROM events_1 "
           "WHERE event IN (?)")
    with pytest.raises(native.NativeScanError, match="JSON"):
        native.scan_ratings_sqlite(rated_db, sql, ["rate"], True)
    with pytest.raises(RuntimeError, match="JSON"):
        jax_native.scan_ratings_sqlite(rated_db, sql, ["rate"], True)


def test_jsonl_scan_equals_reference():
    lines = [
        {"event": "rate", "entityType": "user", "entityId": f"u{k}",
         "targetEntityType": "item", "targetEntityId": f"i{k % 7}",
         "properties": {"rating": k % 5 + 0.5}, "eventId": f"id{k}",
         "eventTime": f"2021-0{k % 9 + 1}-1{k % 10}T01:02:03.{k:03d}Z"}
        for k in range(200)
    ]
    lines[3]["entityId"] = "u\\u00e9"          # an escape: Python re-parse
    lines[4]["tags"] = ["a"]                    # tags: Python re-parse
    lines[5].pop("eventTime")                   # no time: import default
    lines[6]["eventTime"] = "2021-01-01T00:00:00+02:00"
    data = ("\n".join(json.dumps(x) for x in lines) + "\n\n").encode()
    got = native.scan_events_jsonl(data)
    want = jax_native.scan_events_jsonl(data)
    assert got[0] == want[0] == 200
    assert 0 < got[-1].sum() < 200
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _compiler(tmp_path, body: str) -> str:
    p = tmp_path / "cxx.sh"
    p.write_text("#!/bin/sh\n" + body)
    p.chmod(0o755)
    return str(p)


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    count = tmp_path / "count"
    cxx = _compiler(tmp_path, (
        f'echo run >> "{count}"\nsleep 0.3\nprev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        ': > "$out"\n'))
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def go():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert count.read_text().count("run") == 1
    assert {str(p) for p in paths} == {
        str(tmp_path / "build" / native.LIB_NAME)}
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_failing_compiler_raises_without_fallback(tmp_path, monkeypatch):
    cxx = _compiler(tmp_path, 'echo "sqlite_scan.cpp:1: error: boom" >&2\n'
                              "exit 1\n")
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    r = np.zeros(3, np.int32)
    with pytest.raises(native.NativeBuildError, match="error: boom"):
        native.sort_coo_by_row(r, r, np.ones(3, np.float32), 1)
    with pytest.raises(native.NativeBuildError):
        native.native_available()
    assert not (tmp_path / "build" / native.LIB_NAME).exists()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_library_lives_under_build_native():
    assert native.native_available()
    lib = Path(native._lib._name).resolve()
    assert lib == ROOT / "build" / "native" / "libpio_native.so"
    jax_native.native_available()
    assert lib != Path(jax_native._lib._name).resolve()


def test_device_staging_refuses_int32_overflow_as_reference():
    n = 2**31 - 1
    u = np.broadcast_to(np.int32(0), (n,))
    v = np.broadcast_to(np.float32(1), (n,))
    with pytest.raises(ValueError) as want:
        JaxALSTrainer((u, u, v), 1, 1, JaxALSConfig(rank=2),
                      staging="device")
    with pytest.raises(ValueError) as got:
        ALSTrainer((u, u, v), 1, 1, ALSConfig(rank=2), staging="device",
                   device="cpu")
    assert str(got.value) == str(want.value)
    assert "int32 offset range" in str(got.value)
