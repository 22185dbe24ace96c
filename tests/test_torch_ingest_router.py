"""The port's multi-process ingest router against the JAX package's, on
the CPU.

The in-process fleets mirror the reference's ``tests/test_ingest_router
.py``: shard-owner ``EventServer``s (WAL + a stripe of a 4-shard store)
behind an ``IngestRouterServer``, 2 workers; the same request script
goes to the port's fleet and the reference's, and the replies (statuses,
errors, shards, Retry-After, positional batch merges, federated stats)
must be equal, through one worker's death too.  The console's shard
options work, ``--workers`` above the shard count prints the reference's
error, and ``eventserver --workers 2`` boots real ``python -m
predictionio_tpu_torch eventserver`` workers that survive a SIGKILL with
zero acknowledged loss.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.cli.main import main as jax_main
from predictionio_tpu.server.event_server import (
    EventServer as JaxEventServer,
    EventServerConfig as JaxEventServerConfig,
)
from predictionio_tpu.server.ingest_router import (
    IngestRouterConfig as JaxIngestRouterConfig,
    IngestRouterServer as JaxIngestRouterServer,
    IngestWorker as JaxIngestWorker,
    shards_for_worker as jax_shards_for_worker,
)
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.obs.fleet import parse_prometheus
from predictionio_tpu_torch.server import (
    EventServer,
    EventServerConfig,
    IngestRouterConfig,
    IngestRouterServer,
    IngestWorker,
    shards_for_worker,
)
from predictionio_tpu_torch.server import event_server as event_server_mod
from predictionio_tpu_torch.server import ingest_router as ingest_router_mod
from predictionio_tpu_torch.storage import AccessKey, Storage
from predictionio_tpu_torch.storage.sharded_events import _shard_ix

N_SHARDS = 4
N_WORKERS = 2

PACKAGES = {
    "port": (Storage, AccessKey, EventServer, EventServerConfig,
             IngestWorker, IngestRouterServer, IngestRouterConfig),
    "jax": (JaxStorage, JaxAccessKey, JaxEventServer, JaxEventServerConfig,
            JaxIngestWorker, JaxIngestRouterServer, JaxIngestRouterConfig),
}


def _env(home) -> dict:
    return {
        "PIO_TPU_HOME": str(home),
        "PIO_STORAGE_SOURCES_SH_TYPE": "sqlite-sharded",
        "PIO_STORAGE_SOURCES_SH_PATH": str(home / "shards"),
        "PIO_STORAGE_SOURCES_SH_SHARDS": str(N_SHARDS),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH",
    }


def _rate(user, item="i1"):
    return {
        "event": "rate", "entityType": "user", "entityId": user,
        "targetEntityType": "item", "targetEntityId": item,
        "properties": {"rating": 4.0},
        "eventTime": "2020-06-01T00:00:00.000Z",
    }


def _owner_ix(user):
    return _shard_ix("user", user, N_SHARDS) % N_WORKERS


def _users_owned_by(worker_ix, n, prefix="u"):
    out, i = [], 0
    while len(out) < n:
        if _owner_ix(f"{prefix}{i}") == worker_ix:
            out.append(f"{prefix}{i}")
        i += 1
    return out


def _req(url, method="GET", payload=None, raw=None):
    """(status, body, Retry-After) of one request."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return (r.status, json.loads(r.read().decode()),
                    r.headers.get("Retry-After"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), \
            e.headers.get("Retry-After")


def _read_back(f, eid):
    """GET an event by id through the router.  Keyspace-wide reads take
    any healthy worker, and a 201 can precede read visibility on a
    worker that is not the owner by one group-commit drain: retry
    briefly before judging the read."""
    for _ in range(50):
        st, got, _ = _req(f.url(f"/events/{eid}.json"))
        if st == 200:
            break
        time.sleep(0.05)
    return st, got


def _total(stats):
    cur = stats.get("currentHour") or {}
    return sum(r["count"] for r in cur.get("statusCount", []))


def _norm(x):
    """A reply without what differs between any two runs: event ids,
    times, and free-text messages (the structured fields stay)."""
    if isinstance(x, dict):
        return {k: "X" if k in ("eventId", "startTime", "creationTime",
                                "message") else _norm(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


class Fleet:
    """One package's in-process fleet: N_WORKERS shard-owner event
    servers (WAL + a stripe) over one sharded store, behind a router."""

    def __init__(self, tmp_path, name):
        (storage_cls, key_cls, srv_cls, srv_cfg, worker_cls, router_cls,
         router_cfg) = PACKAGES[name]
        home = tmp_path / name
        # one Storage per worker: each EventServer restricts ITS
        # event-store handle to its stripe, as separate processes would
        self.storages = [storage_cls(_env(home)) for _ in range(N_WORKERS)]
        md = self.storages[0].get_metadata()
        app = md.app_insert("levee")
        self.key = md.access_key_insert(key_cls(key="", appid=app.id))
        self.servers, self.workers = [], []
        for i in range(N_WORKERS):
            stripe = shards_for_worker(i, N_WORKERS, N_SHARDS)
            srv = srv_cls(self.storages[i], srv_cfg(
                port=0, wal_dir=str(home / f"wal-{i}"),
                owned_shards=stripe))
            srv.start_background()
            self.servers.append(srv)
            self.workers.append(worker_cls(
                f"ingest-{i}", "127.0.0.1", srv.config.port,
                shards=stripe, index=i))
        # no health sweeps of their own: a test marks a worker down with
        # check_worker (kill), so no sweep can race it (the port's sweep
        # interval is a module constant, set by the fixture)
        sweeps = {"health_interval_s": 3600.0} if name == "jax" else {}
        self.router = router_cls(self.workers, router_cfg(
            port=0, n_shards=N_SHARDS, **sweeps))
        self.router.start_background()
        self.base = f"http://127.0.0.1:{self.router.port}"

    def url(self, path, **params):
        q = "&".join(f"{k}={v}" for k, v in
                     {"accessKey": self.key, **params}.items())
        return f"{self.base}{path}?{q}"

    def kill(self, i):
        """Stop worker i as a process death would, and let the router's
        health check see it down.  A dead process's connections close
        with it; the reference's stopped in-process server goes on
        answering its open keep-alive connections (ROADMAP Queue 3), so
        the router's pooled ones are closed here too."""
        w = self.workers[i]
        self.servers[i].stop()
        with w._lock:
            pool, w._pool = w._pool, []
        for c in pool:
            c.close()
        assert not self.router.check_worker(w) and not w.healthy

    def close(self):
        self.router.stop()
        for s in self.servers:
            s.stop()
        for st in self.storages:
            st.close()


@pytest.fixture
def fleets(tmp_path, monkeypatch):
    monkeypatch.setattr(ingest_router_mod, "_HEALTH_INTERVAL_S", 3600.0)
    made = {name: Fleet(tmp_path, name) for name in PACKAGES}
    yield made
    for f in made.values():
        f.close()


def _both(fleets, script):
    """The script's replies on both fleets, equal up to ``_norm``."""
    got, want = script(fleets["port"]), script(fleets["jax"])
    assert _norm(got) == _norm(want)
    return got


# -- routing table -------------------------------------------------------------


def test_shards_for_worker_partitions_exactly():
    for n_workers in (1, 2, 3, 4):
        for n_shards in (4, 7, 16):
            stripes = [shards_for_worker(i, n_workers, n_shards)
                       for i in range(n_workers)]
            assert stripes == [jax_shards_for_worker(i, n_workers, n_shards)
                               for i in range(n_workers)]
            flat = [s for st in stripes for s in st]
            assert sorted(flat) == list(range(n_shards))
            sizes = [len(st) for st in stripes]
            assert max(sizes) - min(sizes) <= 1


def test_router_rejects_bad_ownership_maps():
    def w(name, shards, ix):
        return IngestWorker(name, "127.0.0.1", 1, shards=shards, index=ix)

    with pytest.raises(ValueError, match="claimed by both"):
        IngestRouterServer([w("a", [0, 1], 0), w("b", [1, 2, 3], 1)],
                           IngestRouterConfig(n_shards=4))
    with pytest.raises(ValueError, match="no owner"):
        IngestRouterServer([w("a", [0, 1], 0)],
                           IngestRouterConfig(n_shards=4))
    with pytest.raises(ValueError, match="at least one worker"):
        IngestRouterServer([], IngestRouterConfig(n_shards=4))


# -- healthy fleet -------------------------------------------------------------


def test_single_events_and_webhooks_route_to_their_owner(fleets):
    users = _users_owned_by(0, 2) + _users_owned_by(1, 2)

    def script(f):
        fwd0 = [w.forwarded for w in f.workers]
        posted = [_req(f.url("/events.json"), "POST", _rate(u))
                  for u in users]
        # each worker saw exactly its owned entities
        out = [[w.forwarded - n for w, n in zip(f.workers, fwd0)]]
        for st, body, _ in posted:
            st2, got = _read_back(f, body["eventId"])
            out.append((st, st2, got["entityId"]))
        # a webhook's connector names the entity: the router runs it to
        # find the owner
        out.append(_req(f.url("/webhooks/examplejson.json"), "POST", {
            "type": "rate", "userId": users[0], "itemId": "i2",
            "timestamp": "2020-06-02T00:00:00.000Z", "rating": 5.0}))
        out.append(_req(f.url("/webhooks/nosuch.json"), "POST", {}))
        # entity-scoped reads go to the owner (read-your-writes)
        out.append(_req(f.url("/events.json", entityType="user",
                              entityId=users[0])))
        return out

    got = _both(fleets, script)
    assert got[0] == [2, 2]
    assert got[1:5] == [(201, 200, u) for u in users]
    assert got[5][0] == 201 and got[6][0] == 404
    assert got[7][0] == 200 and len(got[7][1]) == 2


def test_batch_merges_positionally_and_rejects_what_the_reference_does(
        fleets):
    users = _users_owned_by(0, 3) + _users_owned_by(1, 2)
    batch = [_rate(u) for u in users]
    batch.insert(2, {"event": "rate"})            # unroutable entry

    def script(f):
        out = [_req(f.url("/batch/events.json"), "POST", batch)]
        out.append(_req(f.url("/batch/events.json"), "POST",
                        [_rate(f"u{i}") for i in range(51)]))
        out.append(_req(f.url("/batch/events.json"), "POST",
                        raw=b"{not json"))
        for r in out[0][1]:
            if r["status"] == 201:
                st, got = _read_back(f, r["eventId"])
                out.append((st, got["entityId"]))
        return out

    got = _both(fleets, script)
    assert [r["status"] for r in got[0][1]] == [201, 201, 400, 201, 201, 201]
    assert [g[0] for g in got[1:3]] == [400, 400]
    assert got[3:] == [(200, u) for u in users]

    # a batch with a bad access key: each event answers 401 ...
    def refused_then_read(f):
        st, body, _ = _req(f.url("/batch/events.json", accessKey="bad"),
                           "POST", batch[:2])
        assert st == 200 and [r["status"] for r in body] == [401, 401]
        req = urllib.request.Request(f.url(
            "/events.json", entityType="user", entityId=users[0]))
        try:
            with urllib.request.urlopen(req, timeout=15) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    # ... and the owner's next request on the router's pooled keep-alive
    # connection reads 200 in the port, which drains the refused body;
    # the reference's worker parses that body as the next request line
    # (400, ROADMAP Queue 3)
    assert refused_then_read(fleets["port"]) == 200
    assert refused_then_read(fleets["jax"]) == 400


def test_stats_federate_and_metrics_wait_for_their_item(fleets):
    def script(f):
        for u in _users_owned_by(0, 2) + _users_owned_by(1, 2):
            assert _req(f.url("/events.json"), "POST", _rate(u))[0] == 201
        st, stats, _ = _req(f.url("/stats.json"))
        _, status, _ = _req(f.base + "/")
        return [st, stats, status["healthyWorkers"],
                sorted(status["shardOwners"].items()), status["nShards"]]

    got = _both(fleets, script)
    assert _total(got[1]) == 4
    assert got[1]["workers"] == {"total": 2, "healthy": 2, "reporting": 2}
    # the /metrics federation is ported (it answered 404 before): after a
    # scrape of each worker, both routers merge the same families, each
    # gauge labeled by worker
    merged = {}
    for name, f in fleets.items():
        assert all(w.scrape(5.0) for w in f.workers)
        with urllib.request.urlopen(f.base + "/metrics", timeout=30) as r:
            assert r.status == 200
            merged[name] = parse_prometheus(r.read().decode())
    names = [{fam["name"] for fam in m["families"]} for m in merged.values()]
    assert names[0] == names[1]
    up = next(fam for fam in merged["port"]["families"]
              if fam["name"] == "pio_ingest_worker_up")
    workers = {dict(map(tuple, c["labels"])).get("worker")
               for c in up["children"]}
    assert {"ingest-0", "ingest-1"} <= workers


# -- one shard owner down ------------------------------------------------------


def test_one_worker_down_replies_equal_the_references(fleets):
    dead_users = _users_owned_by(0, 3)
    live_users = _users_owned_by(1, 3)

    def script(f):
        out = [_req(f.url("/events.json"), "POST", _rate(u))[0]
               for u in (dead_users[0], live_users[0])]
        _, stats0, _ = _req(f.url("/stats.json"))
        f.kill(0)
        # healthy shards: zero errors; dead shards: a structured 503
        out += [_req(f.url("/events.json"), "POST", _rate(u))
                for u in live_users + dead_users]
        mixed = [dead_users[1], live_users[1], dead_users[2],
                 live_users[2]]
        out.append(_req(f.url("/batch/events.json"), "POST",
                        [_rate(u) for u in mixed]))
        out.append(_req(f.url("/events.json", entityType="user",
                              entityId=dead_users[0])))
        # keyspace-wide reads take the healthy worker
        out.append(_req(f.url("/events.json", limit=-1))[0])
        _, stats1, _ = _req(f.url("/stats.json"))
        out.append((_total(stats1) >= _total(stats0), stats1["workers"]))
        _, status, _ = _req(f.base + "/")
        out.append((status["healthyWorkers"],
                    f.router.shard_unavailable))
        return out

    got = _both(fleets, script)
    assert got[:2] == [201, 201]
    singles = got[2:8]
    assert [s[0] for s in singles] == [201] * 3 + [503] * 3
    for (st, body, retry), u in zip(singles[3:], dead_users):
        assert body["error"] == "ShardUnavailable" and retry == "2"
        assert body["shard"] == _shard_ix("user", u, N_SHARDS)
    st, body, retry = got[8]
    assert st == 200 and retry == "2"
    assert [(r["status"], r.get("error")) for r in body] == [
        (503, "ShardUnavailable"), (201, None),
        (503, "ShardUnavailable"), (201, None)]
    assert got[9][0] == 503 and got[9][1]["error"] == "ShardUnavailable"
    assert got[10] == 200
    assert got[11] == (True, {"total": 2, "healthy": 1, "reporting": 2})
    assert got[12] == (1, len(dead_users) + 3)


def test_stats_stay_monotone_through_a_death(fleets):
    def script(f):
        for u in _users_owned_by(0, 4) + _users_owned_by(1, 4):
            assert _req(f.url("/events.json"), "POST", _rate(u))[0] == 201
        _, before, _ = _req(f.url("/stats.json"))
        f.kill(1)
        _, after, _ = _req(f.url("/stats.json"))
        return [_total(before), _total(after), after["workers"],
                _req(f.url("/stats.json", accessKey="bad"))[0]]

    got = _both(fleets, script)
    assert got[0] == got[1] == 8
    assert got[2] == {"total": 2, "healthy": 1, "reporting": 2}
    assert got[3] == 401


# -- the console ---------------------------------------------------------------


def _console_server(monkeypatch, argv, storage):
    """Run ``main(argv)`` in a thread until its event server serves;
    returns (thread, server, exit codes)."""
    made = []
    real_init = event_server_mod.EventServer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(event_server_mod.EventServer, "__init__", init)
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(
        main(argv, storage=storage, device="cpu")), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not (made and made[0]._serving):
        assert t.is_alive() and time.monotonic() < deadline
        time.sleep(0.02)
    return t, made[0], rcs


def test_console_shard_options_work(tmp_path, monkeypatch, capsys):
    cases = (
        (["--owned-shards", "0,2", "--wal-dir", str(tmp_path / "w0")],
         [0, 2]),
        (["--worker-index", "1", "--worker-count", "2",
          "--compact-interval", "0.5"], [1, 3]),
    )
    for k, (flags, owned) in enumerate(cases):
        st = Storage(_env(tmp_path / f"h{k}"))
        md = st.get_metadata()
        app = md.app_insert("levee")
        key = md.access_key_insert(AccessKey(key="", appid=app.id))
        t, srv, rcs = _console_server(
            monkeypatch, ["eventserver", "--ip", "127.0.0.1", "--port", "0",
                          *flags], st)
        try:
            assert srv.config.owned_shards == owned
            assert st.get_event_store().owned_shards == set(owned)
            users = {_shard_ix("user", f"u{i}", N_SHARDS): f"u{i}"
                     for i in range(40)}
            base = f"http://127.0.0.1:{srv.port}/events.json?accessKey={key}"
            for s, u in sorted(users.items()):
                status, body, retry = _req(base, "POST", _rate(u))
                assert (status == 201) == (s in owned), (s, body)
                if s not in owned:
                    assert body["shard"] == s and retry == "2"
            if "--compact-interval" in flags:
                assert srv.config.compact_interval_s == 0.5
                assert srv._maint_thread.is_alive()
            if "--wal-dir" in flags:
                assert srv.wal.owned == {0, 2}
        finally:
            srv.stop()
            t.join(timeout=30)
        assert not t.is_alive() and rcs == [0]
        # the reference's line: the port it was asked for (0 =
        # ephemeral; --port-file announces the bound one)
        assert capsys.readouterr().out == (
            f"Event server running on 127.0.0.1:0 (shard owner: {owned})\n")
        st.close()


def test_app_commands_work_on_a_sharded_store(tmp_path, capsys):
    """``app new``, ``import``, ``trim``, ``compact`` and ``data-delete``
    through both consoles on a sharded source: the same output and the
    same rows per shard."""
    src = tmp_path / "events.jsonl"
    with open(src, "w") as f:
        for k in range(60):
            f.write(json.dumps(dict(
                _rate(f"u{k % 17}", f"i{k % 5}"), eventId=f"e{k}",
                eventTime=f"20{10 + k % 12}-06-01T00:00:00.000Z")) + "\n")
    stores = {}
    for name, run, storage_cls in (
            ("port", lambda a, s: main(a, storage=s, device="cpu"), Storage),
            ("jax", lambda a, s: jax_main(a, storage=s), JaxStorage)):
        st = storage_cls(_env(tmp_path / name))
        outs = []
        for argv in (["app", "new", "shop", "--access-key", "k"],
                     ["import", "--appid", "1", "--input", str(src)],
                     ["app", "trim", "shop", "--before",
                      "2015-01-01T00:00:00.000Z"],
                     ["app", "compact"]):
            outs.append((run(argv, st), capsys.readouterr().out))
        es = st.get_event_store()
        rows = [sorted(r[0] for r in sh.iter_raw_rows(1))
                for sh in es.shards]
        outs.append((run(["app", "data-delete", "shop"], st),
                     capsys.readouterr().out))
        stores[name] = (outs, rows,
                        [sum(1 for _ in sh.iter_raw_rows(1))
                         for sh in es.shards])
        st.close()
    assert stores["port"] == stores["jax"]
    outs, rows, after = stores["port"]
    assert [rc for rc, _ in outs] == [0] * 5
    assert sum(map(len, rows)) == 35 and all(rows) and after == [0] * 4


def test_workers_above_the_shard_count_print_the_references_error(
        tmp_path, capsys):
    outs = []
    for name, run, storage_cls in (
            ("port", lambda a, s: main(a, storage=s, device="cpu"), Storage),
            ("jax", lambda a, s: jax_main(a, storage=s), JaxStorage)):
        st = storage_cls(_env(tmp_path / name))
        rc = run(["eventserver", "--workers", "5", "--port", "0"], st)
        outs.append((rc, capsys.readouterr().out))
        st.close()
    assert outs[0] == outs[1] == (1, (
        "error: --workers 5 exceeds the store's 4 shards; extra workers "
        "would own nothing\n"))


def test_eventserver_workers_survive_a_sigkill_with_no_acked_loss(
        tmp_path, monkeypatch, capsys):
    """``eventserver --workers 2`` through the console: two real worker
    processes; worker 0 is SIGKILLed under load, its shards answer 503,
    the supervisor respawns it on its WAL directory, and every event id
    ever acknowledged reads back through the router.  Every wait is
    bounded; the processes are stopped whatever happens."""
    for k, v in _env(tmp_path).items():
        monkeypatch.setenv(k, v)
    st = Storage(_env(tmp_path))
    md = st.get_metadata()
    app = md.app_insert("levee")
    key = md.access_key_insert(AccessKey(key="", appid=app.id))
    booted = []
    real_boot = ingest_router_mod.boot_ingest_fleet

    def boot(*a, **kw):
        out = real_boot(*a, **kw)
        booted.append(out)
        return out

    monkeypatch.setattr(ingest_router_mod, "boot_ingest_fleet", boot)
    pf = tmp_path / "router.port"
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(main(
        ["eventserver", "--workers", "2", "--ip", "127.0.0.1", "--port",
         "0", "--port-file", str(pf), "--wal-dir", str(tmp_path / "wal")],
        storage=st, device="cpu")), daemon=True)
    t.start()
    router = None
    try:
        deadline = time.monotonic() + 120
        while not pf.exists() or not pf.read_text().endswith("\n"):
            assert t.is_alive() and time.monotonic() < deadline
            time.sleep(0.05)
        router, spawned = booted[0]
        base = f"http://127.0.0.1:{int(pf.read_text())}"
        ev_url = f"{base}/events.json?accessKey={key}"
        acked = []
        for i in range(12):
            status, body, _ = _req(ev_url, "POST", _rate(f"a{i}"))
            assert status == 201
            acked.append(body["eventId"])
        os.kill(spawned[0]["proc"].pid, signal.SIGKILL)
        spawned[0]["proc"].wait(timeout=30)
        dead = []
        for i in range(12):
            u = f"k{i}"
            status, body, retry = _req(ev_url, "POST", _rate(u))
            if _owner_ix(u) == 1:
                assert status == 201
                acked.append(body["eventId"])
            else:
                dead.append((status, body.get("error"), retry))
        assert dead and set(dead) == {(503, "ShardUnavailable", "2")}
        # the supervisor respawns worker 0 on its WAL directory
        while not (router.supervisor.respawns >= 1
                   and router.workers[0].healthy):
            assert time.monotonic() < deadline, router.status_json()
            time.sleep(0.1)
        for i in range(6):
            status, body, _ = _req(ev_url, "POST", _rate(f"r{i}"))
            assert status == 201
            acked.append(body["eventId"])
        missing = [eid for eid in acked
                   if _req(f"{base}/events/{eid}.json?accessKey={key}")[0]
                   != 200]
        assert not missing and len(acked) >= 18
        assert _req(f"{base}/stop", "POST", {})[0] == 200
        t.join(timeout=60)
        assert not t.is_alive() and rcs == [0]
        # a clean stop with --wal-dir leaves no fleet directory behind
        assert not spawned[0]["log_path"].parent.exists()
    finally:
        if router is not None:
            router.stop()
            for p in ([s["proc"] for s in booted[0][1]]
                      + router.supervisor.live_procs()):
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
        st.close()
    procs = [s["proc"] for s in booted[0][1]] + \
        booted[0][0].supervisor.live_procs()
    assert all(p.poll() is not None for p in procs)
    out = capsys.readouterr().out
    assert out.count("Ingest worker ") == 2
    assert "Ingest router fronting 2 shard-owner workers (4 shards)" in out
