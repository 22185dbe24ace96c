"""Concurrent writers of one event store, on the CPU.

A batch on the 4-shard store opens one bulk scope across the shards it
touches, and a single insert on another thread writes one shard.  Every
write must succeed, none may wait a second, and a long bulk scope (an
importer's) must not block readers.
"""

import threading
import time

from predictionio_tpu_torch.storage import Event, ShardedSQLiteEventStore
from predictionio_tpu_torch.storage.sharded_events import _shard_ix
from predictionio_tpu_torch.storage.sqlite_events import SQLiteEventStore

N_SHARDS = 4
APP = 1


def _rate(user: str, item: str) -> Event:
    return Event(event="rate", entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties={"rating": 4.0})


def _users_per_shard() -> list[str]:
    """One user id routed to each shard."""
    got: dict[int, str] = {}
    k = 0
    while len(got) < N_SHARDS:
        got.setdefault(_shard_ix("user", f"u{k}", N_SHARDS), f"u{k}")
        k += 1
    return [got[i] for i in range(N_SHARDS)]


def test_batches_and_single_inserts_never_stall_each_other(tmp_path):
    store = ShardedSQLiteEventStore(tmp_path / "es", n_shards=N_SHARDS)
    store.init_channel(APP)
    users = _users_per_shard()
    stop = threading.Event()
    waits = {"batch": [], "single": []}
    errors: list[BaseException] = []
    n_batches = 40

    def batches():
        try:
            for b in range(n_batches):
                events = [_rate(u, f"b{b}-{j}") for j in range(5)
                          for u in users]
                t0 = time.perf_counter()
                store.insert_batch(events, APP)
                waits["batch"].append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            stop.set()

    def singles():
        k = 0
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                store.insert(_rate(users[k % N_SHARDS], f"s{k}"), APP)
                waits["single"].append(time.perf_counter() - t0)
                k += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=batches),
               threading.Thread(target=singles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(waits["batch"]) == n_batches and waits["single"]
    assert max(waits["batch"]) < 1.0, max(waits["batch"])
    assert max(waits["single"]) < 1.0, max(waits["single"])
    rows = list(store.find(APP))
    assert len(rows) == n_batches * 5 * N_SHARDS + len(waits["single"])
    store.close()


def test_a_bulk_scope_blocks_no_reader_and_holds_back_writers(tmp_path):
    store = SQLiteEventStore(tmp_path / "events.db")
    store.init_channel(APP)
    store.insert(_rate("u0", "i0"), APP)
    inside = threading.Event()
    release = threading.Event()
    seen = {}

    def importer():
        with store.bulk():
            store.insert_batch([_rate("u1", f"i{j}") for j in range(10)],
                               APP)
            inside.set()
            release.wait(10)

    def reader():
        t0 = time.perf_counter()
        seen["rows"] = len(list(store.find(APP)))
        seen["read_s"] = time.perf_counter() - t0

    def writer():
        t0 = time.perf_counter()
        store.insert(_rate("u2", "i0"), APP)
        seen["write_s"] = time.perf_counter() - t0

    imp = threading.Thread(target=importer)
    imp.start()
    assert inside.wait(10)
    rd = threading.Thread(target=reader)
    rd.start()
    rd.join(5)
    assert not rd.is_alive()
    # the reader sees the committed row only, without waiting
    assert seen["rows"] == 1 and seen["read_s"] < 1.0
    wr = threading.Thread(target=writer)
    wr.start()
    time.sleep(0.2)
    assert "write_s" not in seen  # waits for the scope, not in sqlite
    release.set()
    imp.join(10)
    wr.join(10)
    assert not imp.is_alive() and not wr.is_alive()
    assert seen["write_s"] < 5.0
    assert len(list(store.find(APP))) == 12
    store.close()
