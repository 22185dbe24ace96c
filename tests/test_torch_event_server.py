"""The port's REST event server against the JAX package's, on the CPU.

Both packages' servers listen on port 0 over SQLite stores of their own,
each with the same app, access keys and channel; the same request script
goes to both, and every reply must carry the same status, Retry-After
and body, up to the ids and creation times each server generates.
"""

import json
import sqlite3
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from predictionio_tpu.server.event_server import (
    EventServer as JaxEventServer,
    EventServerConfig as JaxEventServerConfig,
)
from predictionio_tpu.storage import (
    AccessKey as JaxAccessKey,
    Storage as JaxStorage,
)
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch.resilience import faults as port_faults
from predictionio_tpu_torch.server import EventServer, EventServerConfig
from predictionio_tpu_torch.storage import AccessKey, Storage

KEY, ONLY_RATE = "key-all", "key-rate"


def _rate(k: int, **kw) -> dict:
    d = {"event": "rate", "entityType": "user", "entityId": f"u{k % 4}",
         "targetEntityType": "item", "targetEntityId": f"i{k % 5}",
         "properties": {"rating": (k % 5) + 0.5},
         "eventTime": f"2023-04-0{k % 9 + 1}T10:00:{k % 60:02d}.000Z"}
    d.update(kw)
    return d


class Client:
    """Requests against one server; replies come back normalized: each
    generated event id is named by its order of first appearance and
    every creation and start time is blanked."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"
        self.ids: dict[str, str] = {}

    def _norm(self, x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in ("creationTime", "startTime"):
                    v = "T"
                elif k == "eventId" and isinstance(v, str):
                    v = self.ids.setdefault(v, f"ID{len(self.ids)}")
                out[k] = self._norm(v)
            return out
        if isinstance(x, list):
            return [self._norm(v) for v in x]
        return x

    def raw_id(self, name: str) -> str:
        return {v: k for k, v in self.ids.items()}[name]

    def call(self, method: str, path: str, body=None, form=None):
        data, headers = None, {}
        if form is not None:
            data = urllib.parse.urlencode(form).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        elif body is not None:
            data = (body if isinstance(body, bytes)
                    else json.dumps(body).encode())
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.base + path, data=data,
                                     headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                status, hdrs, raw = r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            status, hdrs, raw = e.code, e.headers, e.read()
        return status, hdrs.get("Retry-After"), self._norm(json.loads(raw))


@pytest.fixture()
def pair(tmp_path):
    """``start(**config)`` -> (port client, reference client), each
    server over its own store; all stopped at the end."""
    servers = []

    def start(**config):
        clients = []
        for name, storage_cls, key_cls, srv_cls, cfg_cls in (
            ("port", Storage, AccessKey, EventServer, EventServerConfig),
            ("jax", JaxStorage, JaxAccessKey, JaxEventServer,
             JaxEventServerConfig),
        ):
            home = tmp_path / f"{name}{len(servers)}"
            st = storage_cls({"PIO_TPU_HOME": str(home)})
            md = st.get_metadata()
            app = md.app_insert("shop")
            md.access_key_insert(key_cls(key=KEY, appid=app.id))
            md.access_key_insert(key_cls(key=ONLY_RATE, appid=app.id,
                                         events=["rate"]))
            md.channel_insert("mobile", app.id)
            cfg = dict(config)
            if "wal_dir" in cfg:
                cfg["wal_dir"] = str(home / "wal")
            srv = srv_cls(st, cfg_cls(port=0, write_backoff_s=0.001,
                                      retry_seed=0, **cfg))
            srv.start_background()
            servers.append(srv)
            clients.append((Client(srv.config.port), st))
        return clients

    yield start
    for srv in servers:
        srv.stop()


def _same(script, clients):
    got = script(clients[0][0])
    want = script(clients[1][0])
    assert got == want
    return got


def test_single_and_batch_posts(pair):
    def script(c):
        return [
            c.call("GET", "/"),
            c.call("POST", f"/events.json?accessKey={KEY}", _rate(0)),
            c.call("POST", f"/events.json?accessKey={KEY}",
                   _rate(1, eventId="mine")),
            c.call("POST", f"/events.json?accessKey={KEY}",
                   {"event": "$unset", "entityType": "user",
                    "entityId": "u1"}),
            c.call("POST", f"/events.json?accessKey={KEY}", b"{not json"),
            c.call("POST", f"/batch/events.json?accessKey={KEY}",
                   [_rate(2), {"event": "rate"}, _rate(3, eventId="b3"),
                    _rate(4, entityId="")]),
            c.call("POST", f"/batch/events.json?accessKey={KEY}",
                   [_rate(k) for k in range(51)]),
            c.call("POST", f"/batch/events.json?accessKey={KEY}",
                   {"not": "a list"}),
            c.call("POST", f"/nowhere.json?accessKey={KEY}", {}),
        ]

    got = _same(script, pair())
    assert [r[0] for r in got] == [200, 201, 201, 400, 400, 200, 400, 400, 404]
    assert [x["status"] for x in got[5][2]] == [201, 400, 201, 400]
    assert "limited to 50" in got[6][2]["message"]


def test_access_keys(pair):
    def script(c):
        return [
            c.call("POST", "/events.json", _rate(0)),
            c.call("POST", "/events.json?accessKey=nope", _rate(0)),
            c.call("POST", f"/events.json?accessKey={ONLY_RATE}",
                   _rate(0, event="buy")),
            c.call("POST", f"/events.json?accessKey={ONLY_RATE}", _rate(0)),
            c.call("POST", f"/batch/events.json?accessKey={ONLY_RATE}",
                   [_rate(1), _rate(2, event="buy")]),
            c.call("GET", "/events.json?accessKey=nope"),
            c.call("POST", f"/events.json?accessKey={KEY}&channel=nochan",
                   _rate(0)),
        ]

    got = _same(script, pair())
    assert [r[0] for r in got] == [401, 401, 401, 201, 200, 401, 401]
    assert [x["status"] for x in got[4][2]] == [201, 401]


def test_channels_and_get_filters(pair):
    def script(c):
        out = [c.call("POST", f"/events.json?accessKey={KEY}", _rate(k))
               for k in range(12)]
        out.append(c.call("POST", f"/events.json?accessKey={KEY}",
                          {"event": "view", "entityType": "user",
                           "entityId": "u9",
                           "eventTime": "2023-04-05T00:00:00.000Z"}))
        out.append(c.call(
            "POST", f"/events.json?accessKey={KEY}&channel=mobile",
            _rate(20)))
        for q in ("", "&entityType=user&entityId=u1",
                  "&event=view&event=rate&limit=3&reversed=true",
                  "&targetEntityType=none", "&targetEntityId=i2",
                  "&startTime=2023-04-03T00:00:00.000Z"
                  "&untilTime=2023-04-05T00:00:00.000Z",
                  "&entityType=nobody", "&channel=mobile"):
            out.append(c.call("GET", f"/events.json?accessKey={KEY}{q}"))
        return out

    got = _same(script, pair())
    assert got[-2][0] == 404 and len(got[-1][2]) == 1
    assert len(got[-8][2]) == 13 and len(got[-6][2]) == 3


def test_get_and_delete_by_id(pair):
    def script(c):
        out = [c.call("POST", f"/events.json?accessKey={KEY}", _rate(k))
               for k in range(3)]
        eid = c.raw_id("ID1")
        out += [
            c.call("GET", f"/events/{eid}.json?accessKey={KEY}"),
            c.call("DELETE", f"/events/{eid}.json?accessKey={KEY}"),
            c.call("DELETE", f"/events/{eid}.json?accessKey={KEY}"),
            c.call("GET", f"/events/{eid}.json?accessKey={KEY}"),
            c.call("DELETE", f"/events/{eid}.json?accessKey=nope"),
            c.call("DELETE", f"/other.json?accessKey={KEY}"),
        ]
        return out

    got = _same(script, pair())
    assert [r[0] for r in got[3:]] == [200, 200, 404, 404, 401, 404]


def test_stats(pair):
    def script(c):
        out = [c.call("POST", f"/events.json?accessKey={KEY}", _rate(k))
               for k in range(4)]
        out.append(c.call("POST", f"/events.json?accessKey={KEY}",
                          {"event": "rate"}))
        out.append(c.call("POST", f"/batch/events.json?accessKey={KEY}",
                          [_rate(9), {"event": "$set"}]))
        out.append(c.call("GET", f"/stats.json?accessKey={KEY}"))
        return out

    got = _same(script, pair())
    life = got[-1][2]["lifetime"]
    assert {(r["status"], r["count"]) for r in life["statusCount"]} == {
        (201, 5), (400, 2)}


def test_webhooks(pair):
    segment = {"type": "identify", "userId": "w1", "traits": {"a": 1},
               "timestamp": "2023-04-01T00:00:00.000Z"}
    chimp = {"type": "subscribe", "fired_at": "2023-04-02 01:02:03",
             "data[id]": "m1", "data[list_id]": "L1",
             "data[email]": "a@b.c", "data[email_type]": "html",
             "data[merges][EMAIL]": "a@b.c", "data[merges][FNAME]": "A",
             "data[merges][LNAME]": "B", "data[ip_opt]": "1.2.3.4",
             "data[ip_signup]": "5.6.7.8"}

    def script(c):
        return [
            c.call("POST", f"/webhooks/segmentio.json?accessKey={KEY}",
                   segment),
            c.call("POST", f"/webhooks/segmentio.json?accessKey={KEY}",
                   {"type": "track"}),
            c.call("POST", f"/webhooks/mailchimp.form?accessKey={KEY}",
                   form=chimp),
            c.call("POST", f"/webhooks/mailchimp.form?accessKey={KEY}",
                   form={"type": "subscribe"}),
            c.call("POST", f"/webhooks/nope.json?accessKey={KEY}", {}),
            c.call("GET", f"/webhooks/segmentio.json?accessKey={KEY}"),
            c.call("GET", f"/webhooks/nope.json?accessKey={KEY}"),
            c.call("GET", f"/events.json?accessKey={KEY}"),
        ]

    got = _same(script, pair())
    assert [r[0] for r in got] == [201, 400, 201, 400, 404, 200, 404, 200]
    assert {e["event"] for e in got[-1][2]} == {"identify", "subscribe"}


def test_locked_store_answers_503_after_the_retries(pair):
    clients = pair(write_retries=3)
    calls = []
    for _, st in clients:
        es = st.get_event_store()

        def locked(*a, _n=calls, **kw):
            _n.append(1)
            raise sqlite3.OperationalError("database is locked")

        es.insert = es.insert_batch = locked

    def script(c):
        return [
            c.call("POST", f"/events.json?accessKey={KEY}", _rate(0)),
            c.call("POST", f"/batch/events.json?accessKey={KEY}",
                   [_rate(1), {"event": "rate"}]),
            c.call("GET", f"/stats.json?accessKey={KEY}"),
        ]

    got = _same(script, clients)
    assert got[0][:2] == (503, "1")
    assert got[0][2]["error"] == "StorageUnavailable"
    assert got[1][:2] == (200, "1")
    assert [x["status"] for x in got[1][2]] == [503, 400]
    assert got[2][2]["resilience"] == {"storage.write.retry": 4}
    # two servers x two writes x three tries each
    assert len(calls) == 12


def test_group_commit_server_reads_its_writes(pair):
    def script(c):
        out = [c.call("POST", f"/batch/events.json?accessKey={KEY}",
                      [_rate(k, eventId=f"w{s}-{k}") for k in range(50)])
               for s in range(3)]
        out.append(c.call("POST", f"/events.json?accessKey={KEY}",
                          _rate(7)))
        out.append(c.call("GET", f"/events.json?accessKey={KEY}&limit=-1"))
        return out

    clients = pair(wal_dir="wal")
    got = _same(script, clients)
    assert all(x["status"] == 201 for r in got[:3] for x in r[2])
    assert len(got[-1][2]) == 151
    for _, st in clients:
        assert len(list(st.get_event_store().iter_raw_rows(1))) == 151


def test_unported_options_raise(pair):
    # PIO_FAULT_PLAN is ported (it raised NotImplementedError before):
    # under one plan both servers retry, answer 503 + Retry-After on
    # exhaustion, recover, and book the same rejections in /stats.json
    clients = pair()
    plan = "storage.write:nth=1,times=4,exc=operational"

    def script(c):
        jax_faults.arm(plan)
        port_faults.arm(plan)
        try:
            out = [c.call("POST", f"/events.json?accessKey={KEY}", _rate(k))
                   for k in range(3)]
            out.append(c.call("POST", f"/batch/events.json?accessKey={KEY}",
                              [_rate(k) for k in range(3, 5)]))
        finally:
            jax_faults.disarm()
            port_faults.disarm()
        out.append(c.call("GET", f"/stats.json?accessKey={KEY}"))
        return out

    got = _same(script, clients)
    assert [r[0] for r in got[:3]] == [503, 201, 201]
    assert got[0][1] == "1" and "injected" in got[0][2]["message"]
    assert [x["status"] for x in got[3][2]] == [201, 201]
    assert got[4][0] == 200


def test_ttl_maintenance_purges_old_events(pair):
    def script(c):
        out = [c.call("POST", f"/events.json?accessKey={KEY}",
                      _rate(k, eventTime=f"200{k}-01-01T00:00:00.000Z"))
               for k in range(1, 3)]
        out.append(c.call("POST", f"/events.json?accessKey={KEY}",
                          _rate(5)))
        for _ in range(400):
            stats = c.call("GET", f"/stats.json?accessKey={KEY}")
            if stats[2]["resilience"].get("ttl.purged") == 2:
                break
            time.sleep(0.02)
        out.append(stats[2]["resilience"])
        out.append(c.call("GET", f"/events.json?accessKey={KEY}"))
        return out

    # a ten-year window: the 2001 and 2002 events fall out, 2023 stays
    got = _same(script, pair(ttl_s=10 * 365 * 86400.0,
                             maintenance_interval_s=0.02))
    assert got[3] == {"ttl.purged": 2}
    assert [e["eventTime"] for e in got[4][2]] == [
        "2023-04-06T10:00:05.000Z"]
