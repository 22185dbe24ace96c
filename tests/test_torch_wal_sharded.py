"""The port's group-commit WAL and event server over the sharded store,
against the JAX package's, on the CPU.

One log per owned shard (``shard-<i>.wal``) routed by the store's own
entity hash; a crash (``close(drain=False)``) replays only the owner's
shards, a torn tail included, into the reference's rows; a foreign shard
is refused before anything is logged.  A shard-owner event server
answers the reference's structured 503 for a foreign shard, degrades a
mixed batch by position, and compacts only its own shards on its
timer.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.server.event_server import (
    EventServer as JaxEventServer,
    EventServerConfig as JaxEventServerConfig,
)
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.sharded_events import (
    ShardedSQLiteEventStore as JaxSharded,
)
from predictionio_tpu.storage.wal import (
    GroupCommitWAL as JaxGroupCommitWAL,
    replay_wal_dir as jax_replay_wal_dir,
)
from predictionio_tpu_torch.server import EventServer, EventServerConfig
from predictionio_tpu_torch.storage import (
    AccessKey,
    ShardedSQLiteEventStore,
    ShardUnavailableError,
    Storage,
)
from predictionio_tpu_torch.storage.sharded_events import _shard_ix
from predictionio_tpu_torch.storage.wal import (
    GroupCommitWAL,
    read_records,
    replay_wal_dir,
)

N = 4


def _users(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"u{int(k)}" + ("é" if k % 3 == 0 else "")
            for k in rng.integers(0, 500, n)]


def _row(k: int, user: str) -> tuple:
    return (f"ev{k:05d}", "rate", "user", user, "item", f"i{k % 29}",
            '{"rating":%d}' % (k % 5 + 1), 1_600_000_000_000 + k, "[]",
            None, 1_600_000_000_000)


def _stores(tmp_path):
    out = []
    for cls, name in ((ShardedSQLiteEventStore, "port"),
                      (JaxSharded, "jax")):
        s = cls(tmp_path / name, N)
        s.init_channel(1)
        out.append(s)
    return out


def _shard_rows(store) -> list:
    return [sorted(s.iter_raw_rows(1)) for s in store.shards]


def test_per_shard_logs_hold_the_references_records(tmp_path):
    port, jax = _stores(tmp_path)
    users = _users(0, 240)
    rows = [_row(k, u) for k, u in enumerate(users)]
    for cls, store, name in ((GroupCommitWAL, port, "pwal"),
                             (JaxGroupCommitWAL, jax, "jwal")):
        # a long accumulation window: logged, acknowledged, not drained
        wal = cls(store, tmp_path / name, commit_interval_s=30.0)
        assert [wal.route("user", u) for u in users] == [
            _shard_ix("user", u, N) for u in users]
        for s in range(0, len(rows), 40):
            wal.submit(1, 0, rows[s:s + 40])
        wal.close(drain=False)
    for i in range(N):
        got = read_records(tmp_path / "pwal" / f"shard-{i}.wal")
        want = read_records(tmp_path / "jwal" / f"shard-{i}.wal")
        assert got == want and got[0] and not got[2]
        assert (tmp_path / "pwal" / f"shard-{i}.wal").read_bytes() == (
            tmp_path / "jwal" / f"shard-{i}.wal").read_bytes()
    # the crash's rows come back from either package's logs
    report = replay_wal_dir(tmp_path / "pwal", port)
    jax_replay_wal_dir(tmp_path / "jwal", jax)
    assert report == {"replayed": len(rows), "torn_shards": [],
                      "shards": list(range(N))}
    assert _shard_rows(port) == _shard_rows(jax)
    assert sum(map(len, _shard_rows(port))) == len(rows)


def test_owners_replay_only_their_shards_after_a_crash(tmp_path):
    """Two owners of one store, stripes [0, 2] and [1, 3], crash with
    logged rows; shard 2's log is torn mid-append.  Each restarted
    owner replays exactly its own shards, as the reference does."""
    users = _users(1, 200)
    rows = [_row(k, u) for k, u in enumerate(users)]
    results = {}
    for name, store_cls, wal_cls in (
            ("port", ShardedSQLiteEventStore, GroupCommitWAL),
            ("jax", JaxSharded, JaxGroupCommitWAL)):
        wal_dir = tmp_path / f"{name}-wal"
        owners = {0: [0, 2], 1: [1, 3]}
        stores = {w: store_cls(tmp_path / name, N) for w in owners}
        for w, owned in owners.items():
            stores[w].init_channel(1)
            wal = wal_cls(stores[w], wal_dir / f"worker-{w}",
                          owned_shards=owned, commit_interval_s=30.0)
            mine = [r for r in rows if _shard_ix("user", r[3], N) in owned]
            for s in range(0, len(mine), 25):
                wal.submit(1, 0, mine[s:s + 25])
            wal.close(drain=False)
        log = wal_dir / "worker-0" / "shard-2.wal"
        log.write_bytes(log.read_bytes() + log.read_bytes()[:21])
        fresh = store_cls(tmp_path / f"{name}-fresh", N)
        fresh.init_channel(1)
        wal = wal_cls(fresh, wal_dir / "worker-0", owned_shards=[0, 2])
        results[name] = (wal.replay_report, _shard_rows(fresh))
        wal.close()
    (report, got), (jreport, want) = results["port"], results["jax"]
    assert report == jreport
    assert report["shards"] == [0, 2] and report["torn_shards"] == [2]
    assert got == want
    assert [bool(r) for r in got] == [True, False, True, False]
    assert sum(map(len, got)) == sum(
        1 for r in rows if _shard_ix("user", r[3], N) in (0, 2))


def test_a_foreign_shard_is_refused_before_anything_is_logged(tmp_path):
    port, jax = _stores(tmp_path)
    users = {_shard_ix("user", u, N): u for u in _users(2, 80)}
    refused = []
    for cls, store, name in ((GroupCommitWAL, port, "pwal"),
                             (JaxGroupCommitWAL, jax, "jwal")):
        wal = cls(store, tmp_path / name, owned_shards=[0])
        wal.submit(1, 0, [_row(0, users[0])])
        with pytest.raises(ShardUnavailableError if cls is GroupCommitWAL
                           else Exception, match="not owned") as e:
            wal.submit(1, 0, [_row(1, users[0]), _row(2, users[3])])
        refused.append(e.value.shard)
        wal.close()
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == [
            "shard-0.wal"]
    assert refused == [3, 3]
    assert _shard_rows(port) == _shard_rows(jax)
    assert [len(r) for r in _shard_rows(port)] == [1, 0, 0, 0]
    with pytest.raises(ValueError, match="out of range"):
        GroupCommitWAL(port, tmp_path / "bad", owned_shards=[4])


# -- shard-owner event servers -----------------------------------------------


def _rate(user: str, **kw) -> dict:
    d = {"event": "rate", "entityType": "user", "entityId": user,
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4.0},
         "eventTime": "2020-06-01T00:00:00.000Z"}
    d.update(kw)
    return d


def _call(port: int, method: str, path: str, body=None):
    """(status, Retry-After, body with event ids, creation and start
    times blanked)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()

    def norm(x):
        if isinstance(x, dict):
            return {k: "ID" if k == "eventId" else
                    "T" if k in ("creationTime", "startTime") else norm(v)
                    for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x

    return status, hdrs.get("Retry-After"), norm(json.loads(raw))


@pytest.fixture()
def owners(tmp_path):
    """``start(**config)`` -> [(port, storage)] for the port's and the
    reference's shard-owner servers over their own sharded stores."""
    servers = []

    def start(**config):
        out = []
        for name, storage_cls, key_cls, srv_cls, cfg_cls in (
                ("port", Storage, AccessKey, EventServer,
                 EventServerConfig),
                ("jax", JaxStorage, JaxAccessKey, JaxEventServer,
                 JaxEventServerConfig)):
            home = tmp_path / f"{name}{len(servers)}"
            st = storage_cls({
                "PIO_TPU_HOME": str(home),
                "PIO_STORAGE_SOURCES_SH_TYPE": "sqlite-sharded",
                "PIO_STORAGE_SOURCES_SH_PATH": str(home / "shards"),
                "PIO_STORAGE_SOURCES_SH_SHARDS": str(N),
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH",
            })
            md = st.get_metadata()
            app = md.app_insert("levee")
            md.access_key_insert(key_cls(key="K", appid=app.id))
            cfg = dict(config)
            if cfg.get("wal_dir"):
                cfg["wal_dir"] = str(home / "wal")
            srv = srv_cls(st, cfg_cls(port=0, **cfg))
            srv.start_background()
            servers.append(srv)
            out.append((srv.config.port, st))
        return out

    yield start
    for srv in servers:
        srv.stop()


def test_a_shard_owner_answers_the_references_replies(owners):
    users = {}
    for u in _users(3, 200):
        users.setdefault(_shard_ix("user", u, N), []).append(u)
    mixed = [users[1][0], users[0][0], users[3][0], users[1][1],
             users[2][0]]

    def script(port):
        out = [_call(port, "POST", "/events.json?accessKey=K",
                     _rate(users[s][0])) for s in range(N)]
        out.append(_call(port, "POST", "/batch/events.json?accessKey=K",
                         [_rate(u) for u in mixed]))
        status, _, events = _call(port, "GET",
                                  "/events.json?accessKey=K&limit=-1")
        # one event time for all: the order among them is the random ids'
        out.append((status, sorted(e["entityId"] for e in events)))
        out.append(_call(port, "GET", "/stats.json?accessKey=K"))
        return out

    (port, st), (jport, _) = owners(wal_dir="wal", owned_shards=[1, 3])
    got, want = script(port), script(jport)
    assert got == want
    assert [r[0] for r in got[:N]] == [503, 201, 503, 201]
    assert got[0][1] == "2" and got[0][2]["error"] == "ShardUnavailable"
    assert got[0][2]["shard"] == 0
    assert [r["status"] for r in got[N][2]] == [201, 503, 201, 201, 503]
    assert len(got[N + 1][1]) == 5
    assert st.get_event_store().owned_shards == {1, 3}


def test_a_shard_owner_without_a_wal_splits_a_batch_by_shard(owners):
    """The reference's batch route reaches its WAL-only degraded path
    here and answers 500 (ROADMAP Queue 3); the port answers per
    position, like the WAL route."""
    users = {}
    for u in _users(4, 200):
        users.setdefault(_shard_ix("user", u, N), []).append(u)
    batch = [_rate(users[0][0]), _rate(users[2][0]), _rate(users[0][1])]
    (port, st), (jport, _) = owners(owned_shards=[0])
    status, retry, body = _call(port, "POST",
                                "/batch/events.json?accessKey=K", batch)
    assert status == 200 and retry == "2"
    assert [(r["status"], r.get("shard")) for r in body] == [
        (201, None), (503, 2), (201, None)]
    assert sorted(e.entity_id for e in st.get_event_store().find(1)) == (
        sorted([users[0][0], users[0][1]]))
    assert _call(jport, "POST", "/batch/events.json?accessKey=K",
                 batch)[0] == 500


def test_compaction_timer_compacts_owned_shards_only(owners, monkeypatch):
    compacted = {"port": [], "jax": []}
    (port, st), (jport, jst) = owners(
        owned_shards=[2], compact_interval_s=0.05,
        maintenance_interval_s=0.02)
    for name, storage in (("port", st), ("jax", jst)):
        for i, shard in enumerate(storage.get_event_store().shards):
            monkeypatch.setattr(
                shard, "compact",
                lambda i=i, name=name: compacted[name].append(i))
    deadline = time.monotonic() + 20
    while (min(len(v) for v in compacted.values()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert compacted["port"][:2] == compacted["jax"][:2] == [2, 2]
    assert set(compacted["port"]) == {2}
