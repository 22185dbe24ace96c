"""The port's servers observed and fault-injected as the JAX package's,
on the CPU.

Both packages' event servers, and both engine servers (each serving an
instance its own package trained from the same events), get the same
requests; each ``GET /metrics`` is scraped before and
after, and the deltas must be equal: requests by status, histogram
counts, timeline segment counts.  Under the same fault plan (each
package arms its own ``resilience.faults``) both answer the same
statuses.  The registries are process-wide, so only deltas compare.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.controller.base import (
    WorkflowContext as JaxWorkflowContext,
)
from predictionio_tpu.obs import fleet as jax_fleet
from predictionio_tpu.obs import get_registry as jax_get_registry
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.server.event_server import (
    EventServer as JaxEventServer,
    EventServerConfig as JaxEventServerConfig,
)
from predictionio_tpu.server.serving import (
    EngineServer as JaxEngineServer,
    ServerConfig as JaxServerConfig,
)
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_tpu_torch import obs as port_obs
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.obs import fleet as port_fleet
from predictionio_tpu_torch.resilience import faults as port_faults
from predictionio_tpu_torch.server import (
    EngineServer,
    EventServer,
    EventServerConfig,
    ServerConfig,
)
from predictionio_tpu_torch.storage import AccessKey, Event, Storage
from predictionio_tpu_torch.storage.sharded_events import _shard_ix
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import run_train

N_USERS, N_ITEMS = 30, 20
VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 2, "lambda": 0.05, "seed": 1}}],
}
EVENT_PACKAGES = {
    "port": (Storage, AccessKey, EventServer, EventServerConfig,
             port_fleet, port_faults),
    "jax": (JaxStorage, JaxAccessKey, JaxEventServer, JaxEventServerConfig,
            jax_fleet, jax_faults),
}


def _req(url, method="GET", payload=None, raw=None, headers=None):
    """(status, body, headers) of one request."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            status, body, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), e.headers
    try:
        body = json.loads(body)
    except ValueError:
        body = body.decode()
    return status, body, hdrs


def _scrape(base, fleet) -> dict:
    """``{(family, labels): value or histogram count}`` of /metrics."""
    status, text, _ = _req(base + "/metrics")
    assert status == 200
    out = {}
    for fam in fleet.parse_prometheus(text)["families"]:
        for c in fam["children"]:
            key = (fam["name"], tuple(map(tuple, c["labels"])))
            out[key] = (c["hist"]["count"] if "hist" in c
                        else c.get("value", 0.0))
    return out


def _reference_catalog() -> set:
    """Every family the JAX package registers.  A port exposition holds
    only these; which of them have samples in this process depends on
    the tests run before (the registries are process-wide)."""
    return {f.name for f in jax_get_registry().families()}


def _delta(before, after, families) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k[0] in families and v != before.get(k, 0)}


def _rate(k, **kw):
    d = {"event": "rate", "entityType": "user", "entityId": f"u{k}",
         "targetEntityType": "item", "targetEntityId": f"i{k % 3}",
         "properties": {"rating": 4.0},
         "eventTime": "2021-03-01T00:00:00.000Z"}
    d.update(kw)
    return d


def _event_server(name, home, **cfg):
    storage_cls, key_cls, srv_cls, cfg_cls = EVENT_PACKAGES[name][:4]
    st = storage_cls(home if isinstance(home, dict)
                     else {"PIO_TPU_HOME": str(home)})
    md = st.get_metadata()
    app = md.app_get_by_name("shop") or md.app_insert("shop")
    if not md.access_key_get("k"):
        md.access_key_insert(key_cls(key="k", appid=app.id))
    srv = srv_cls(st, cfg_cls(port=0, write_backoff_s=0.001, retry_seed=0,
                              **cfg))
    srv.start_background()
    return srv, st, f"http://127.0.0.1:{srv.config.port}"


def test_event_servers_book_the_same_metrics(tmp_path):
    fams = ("pio_events_requests_total", "pio_event_write_latency_seconds",
            "pio_events_segment_seconds", "pio_wal_fsync_seconds")
    deltas, names = {}, {}
    for name in EVENT_PACKAGES:
        fleet = EVENT_PACKAGES[name][4]
        srv, st, base = _event_server(name, tmp_path / name,
                                      wal_dir=str(tmp_path / name / "wal"))
        try:
            before = _scrape(base, fleet)
            for k in range(5):
                _req(f"{base}/events.json?accessKey=k", "POST", _rate(k))
            _req(f"{base}/events.json?accessKey=k", "POST", raw=b"{bad")
            _req(f"{base}/events.json?accessKey=nope", "POST", _rate(9))
            _req(f"{base}/batch/events.json?accessKey=k", "POST",
                 [_rate(k) for k in range(5, 9)] + [{"event": "rate"}])
            srv.barrier()
            after = _scrape(base, fleet)
            names[name] = {k[0] for k in after}
            deltas[name] = _delta(before, after, fams)
        finally:
            srv.stop()
            st.close()
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][("pio_events_requests_total",
                           (("status", "201"),))] == 9
    assert names["port"] <= _reference_catalog()


def _seed_events(st) -> None:
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    rng = np.random.default_rng(2)
    u, i = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.4)
    es.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(rng.integers(1, 11) * 0.5)})
        for a, b in zip(u.tolist(), i.tolist())
    ], app.id)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per package, ``(home, instance id)`` of an instance it trained
    from the same seeded events."""
    out = {}
    for name in ("port", "jax"):
        home = tmp_path_factory.mktemp(f"served-{name}")
        st = Storage({"PIO_TPU_HOME": str(home)})
        _seed_events(st)
        if name == "port":
            engine = recommendation_engine()
            iid = run_train(engine, engine.params_from_variant(VARIANT),
                            ctx=WorkflowContext(device="cpu", storage=st))
            st.close()
        else:
            st.close()
            st = JaxStorage({"PIO_TPU_HOME": str(home)})
            engine = jax_recommendation_engine()
            iid = jax_run_train(engine, engine.params_from_variant(VARIANT),
                                ctx=JaxWorkflowContext(storage=st))
            st.close()
        out[name] = (home, iid)
    return out


def _engine_server(name, home, iid, **cfg):
    if name == "port":
        st = Storage({"PIO_TPU_HOME": str(home)})
        engine = recommendation_engine()
        rec = st.get_metadata().engine_instance_get(iid)
        srv = EngineServer(
            engine, engine.params_from_instance(rec), iid,
            ctx=WorkflowContext(device="cpu", storage=st, mode="Serving"),
            config=ServerConfig(port=0, **cfg))
    else:
        st = JaxStorage({"PIO_TPU_HOME": str(home)})
        engine = jax_recommendation_engine()
        rec = st.get_metadata().engine_instance_get(iid)
        srv = JaxEngineServer(
            engine, engine.params_from_instance(rec), iid,
            ctx=JaxWorkflowContext(storage=st, mode="Serving"),
            config=JaxServerConfig(port=0, **cfg))
    srv.start_background()
    return srv, st, f"http://127.0.0.1:{srv.port}"


def _queries(n):
    rng = np.random.default_rng(4)
    return [{"user": f"u{int(rng.integers(N_USERS))}", "num": 3}
            for _ in range(n)]


@pytest.mark.parametrize("edge", ["eventloop", "threads"])
def test_engine_servers_book_the_same_metrics(trained, edge):
    fams = ("pio_queries_total", "pio_query_latency_seconds",
            "pio_serve_segment_seconds", "pio_engine_queries_total",
            "pio_microbatch_batch_size")
    deltas, names = {}, {}
    for name, fleet in (("port", port_fleet), ("jax", jax_fleet)):
        srv, st, base = _engine_server(name, *trained[name], edge=edge)
        try:
            before = _scrape(base, fleet)
            for q in _queries(6):
                assert _req(base + "/queries.json", "POST", q)[0] == 200
            assert _req(base + "/queries.json", "POST", raw=b"{no")[0] == 400
            after = _scrape(base, fleet)
            names[name] = {k[0] for k in after}
            deltas[name] = _delta(before, after, fams)
            status = _req(base + "/")[1]
            assert status["requestCount"] == 6
            assert status["p50ServingSec"] > 0 and "xray" in status
        finally:
            srv.stop()
            st.close()
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][("pio_query_latency_seconds", ())] == 6
    assert names["port"] <= _reference_catalog()


def test_a_traced_query_lands_in_the_journal(trained, tmp_path):
    tracer = port_obs.get_tracer()
    tracer.configure(tmp_path / "journal")
    srv, st, base = _engine_server("port", *trained["port"], edge="threads")
    try:
        status, _, hdrs = _req(base + "/queries.json", "POST",
                               {"user": "u1", "num": 2},
                               headers={"X-PIO-Trace": "t-journal-1"})
        assert status == 200 and hdrs["X-PIO-Trace"] == "t-journal-1"
        (span,) = tracer.spans("t-journal-1")
        assert span.name == "serve.query"
        assert {"parse", "auth", "device", "serialize"} <= set(
            span.attrs["segmentsMs"])
        lines = [json.loads(x) for x in
                 tracer.journal_path().read_text().splitlines()]
        assert any(x["traceId"] == "t-journal-1"
                   and x["name"] == "serve.query" for x in lines)
    finally:
        tracer.configure(None)
        srv.stop()
        st.close()


def test_no_metrics_closes_only_the_mounts(trained, tmp_path):
    es, est, ebase = _event_server("port", tmp_path / "ev")
    srv, st, base = _engine_server("port", *trained["port"])
    port_obs.set_metrics_enabled(False)
    try:
        for b in (base, ebase):
            assert _req(b + "/metrics")[0] == 404
            assert _req(b + "/debug/xray")[0] == 404
        assert _req(base + "/queries.json", "POST", {"user": "u1"})[0] == 200
    finally:
        port_obs.set_metrics_enabled(True)
        for s, store in ((srv, st), (es, est)):
            s.stop()
            store.close()
    srv, st, base = _engine_server("port", *trained["port"])
    try:
        assert _req(base + "/metrics")[0] == 200
        assert _req(base + "/debug/xray")[1]["jit"]["als.half_iteration"][
            "calls"] > 0
    finally:
        srv.stop()
        st.close()


def test_query_and_reload_faults_answer_as_the_reference(trained):
    got = {}
    for name, faults in (("port", port_faults), ("jax", jax_faults)):
        srv, st, base = _engine_server(name, *trained[name])
        out = []
        try:
            faults.arm("device.dispatch:times=1")
            out += [_req(base + "/queries.json", "POST",
                         {"user": "u2", "num": 2})[0] for _ in range(2)]
            faults.arm("reload.load_model:times=1")
            out.append(_req(base + "/reload")[0])
            err = _req(base + "/")[1]["resilience"]["lastReloadError"]
            out.append(err.split(":")[0])
            out.append(_req(base + "/queries.json", "POST",
                            {"user": "u2", "num": 2})[0])
            out.append(_req(base + "/reload")[0])
            out.append(_req(base + "/")[1]["resilience"]["lastReloadError"])
        finally:
            faults.disarm()
            srv.stop()
            st.close()
        got[name] = out
    assert got["port"] == got["jax"] == [
        500, 200, 500, "InjectedFault", 200, 200, None]


def test_a_torn_wal_replays_every_acknowledged_event(tmp_path):
    got = {}
    for name in EVENT_PACKAGES:
        faults = EVENT_PACKAGES[name][5]
        wal = str(tmp_path / name / "wal")
        srv, st, base = _event_server(name, tmp_path / name, wal_dir=wal)
        try:
            codes = [_req(f"{base}/events.json?accessKey=k", "POST",
                          _rate(k))[0] for k in range(3)]
            faults.arm("wal.torn:times=1")
            codes.append(_req(f"{base}/events.json?accessKey=k", "POST",
                              _rate(3))[0])
        finally:
            faults.disarm()
            srv.stop()
            st.close()
        # restart on the same log: replay drops exactly the torn tail
        srv, st, base = _event_server(name, tmp_path / name, wal_dir=wal)
        try:
            codes.append(_req(f"{base}/events.json?accessKey=k", "POST",
                              _rate(4))[0])
            srv.barrier()
            _, events, _ = _req(f"{base}/events.json?accessKey=k&limit=-1")
            users = sorted(e["entityId"] for e in events)
        finally:
            srv.stop()
            st.close()
        got[name] = (codes, users)
    assert got["port"] == got["jax"] == (
        [201, 201, 201, 503, 201], ["u0", "u1", "u2", "u4"])


def test_a_downed_shard_refuses_only_its_own_entities(tmp_path):
    got = {}
    for name in EVENT_PACKAGES:
        faults = EVENT_PACKAGES[name][5]
        home = tmp_path / name
        env = {"PIO_TPU_HOME": str(home),
               "PIO_STORAGE_SOURCES_SH_TYPE": "sqlite-sharded",
               "PIO_STORAGE_SOURCES_SH_PATH": str(home / "shards"),
               "PIO_STORAGE_SOURCES_SH_SHARDS": "4",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH"}
        srv, st, base = _event_server(name, env, wal_dir=str(home / "wal"))
        faults.arm("store.shard_down:shard=1")
        try:
            out = []
            for k in range(12):
                status, body, _ = _req(f"{base}/events.json?accessKey=k",
                                       "POST", _rate(k))
                out.append((_shard_ix("user", f"u{k}", 4), status,
                            body.get("error"), body.get("shard")))
        finally:
            faults.disarm()
            srv.stop()
            st.close()
        got[name] = out
    assert got["port"] == got["jax"]
    assert {s for s, *_ in got["port"]} == {0, 1, 2, 3}
    for shard, status, error, where in got["port"]:
        assert (status, error, where) == (
            (503, "ShardUnavailable", 1) if shard == 1
            else (201, None, None))
