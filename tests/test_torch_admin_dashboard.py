"""The port's admin API and dashboard against the JAX package's.

Mirrors the reference's seven cases (``tests/test_admin_dashboard.py``:
the admin root, app CRUD with the reference's status codes, a missing
name, the dashboard index, the evaluation drill-down, an unknown path,
an URL-encoded app name), each run on both packages' servers over the
same kind of in-memory store, with the answers compared; then every
page of the dashboard answers 200, and ``tenants.html`` and
``experiments.html`` show the port's live tenants and autopilot.
"""

import json
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.server import AdminServer as JaxAdminServer
from predictionio_tpu.server import DashboardServer as JaxDashboardServer
from predictionio_tpu.storage import EvaluationInstance as JaxEvaluationInstance
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu_torch.server import AdminServer, DashboardServer
from predictionio_tpu_torch.storage import (
    Event,
    EvaluationInstance,
    Storage,
)

MEMORY = {
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
}


def _call(url, method="GET", payload=None, raw=False):
    """``(status, body)``; an HTTP error answers its status and body."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body if raw else json.loads(body)


@pytest.fixture()
def admins(tmp_path):
    out = {}
    for kind, server, storage in (
            ("jax", JaxAdminServer, JaxStorage),
            ("torch", AdminServer, Storage)):
        st = storage(dict(MEMORY, PIO_TPU_HOME=str(tmp_path / kind)))
        s = server(st, port=0)
        s.start_background()
        out[kind] = (f"http://127.0.0.1:{s.port}", s, st)
    yield {k: v[0] for k, v in out.items()}
    for _, s, st in out.values():
        s.stop()
        st.close()


def _both(urls, fn):
    """``fn`` on each package's server: equal answers (the package's
    name masked) or the test fails."""
    got = {k: fn(u) for k, u in urls.items()}
    assert json.dumps(got["torch"]).replace(
        "predictionio_tpu_torch", "predictionio_tpu") == json.dumps(
        got["jax"])
    return got["torch"]


def test_admin_root(admins):
    status, body = _both(admins, lambda b: _call(f"{b}/"))
    assert status == 200 and body["status"] == "alive"


def test_admin_app_crud(admins):
    def crud(base):
        out = []
        status, body = _call(f"{base}/cmd/app", "POST", {"name": "adminapp"})
        out.append((status, body["name"], bool(body["accessKey"])))
        _, apps = _call(f"{base}/cmd/app")
        out.append([(a["name"], len(a["accessKeys"])) for a in apps])
        out.append(_call(f"{base}/cmd/app", "POST", {"name": "adminapp"}))
        out.append(_call(f"{base}/cmd/app/adminapp/data", "DELETE"))
        out.append(_call(f"{base}/cmd/app/adminapp", "DELETE"))
        out.append(_call(f"{base}/cmd/app"))
        out.append(_call(f"{base}/cmd/app/ghost", "DELETE"))
        return out

    got = _both(admins, crud)
    assert got[0] == (201, "adminapp", True)
    assert [s for s, _ in got[2:]] == [400, 200, 200, 200, 404]
    assert got[5][1] == []


def test_admin_missing_name_400(admins):
    status, _ = _both(admins, lambda b: _call(f"{b}/cmd/app", "POST", {}))
    assert status == 400


def test_admin_url_encoded_app_name(admins):
    def run(base):
        _call(f"{base}/cmd/app", "POST", {"name": "my app"})
        return (_call(f"{base}/cmd/app/my%20app", "DELETE"),
                _call(f"{base}/cmd/app"))

    deleted, listed = _both(admins, run)
    assert deleted[0] == 200 and listed == (200, [])


def _evaluation(cls):
    return cls(
        id="ev1", status="EVALCOMPLETED",
        start_time="2020-01-01T00:00:00Z", end_time="2020-01-01T01:00:00Z",
        evaluation_class="MyEval", engine_params_generator_class="Gen",
        evaluator_results="[0.5] RMSE",
        evaluator_results_html="<html><body>RMSE</body></html>",
        evaluator_results_json='{"bestScore": 0.5}',
    )


@pytest.fixture()
def dashboards(tmp_path):
    out = {}
    for kind, server, storage, ev in (
            ("jax", JaxDashboardServer, JaxStorage, JaxEvaluationInstance),
            ("torch", DashboardServer, Storage, EvaluationInstance)):
        st = storage(dict(MEMORY, PIO_TPU_HOME=str(tmp_path / kind)))
        st.get_metadata().evaluation_instance_insert(_evaluation(ev))
        s = server(st, port=0)
        s.start_background()
        out[kind] = (f"http://127.0.0.1:{s.port}", s, st)
    yield {k: v[0] for k, v in out.items()}
    for _, s, st in out.values():
        s.stop()
        st.close()


def test_dashboard_index(dashboards):
    status, body = _both(dashboards, lambda b: _call(f"{b}/", raw=True))
    assert status == 200
    assert "ev1" in body and "MyEval" in body and "[0.5] RMSE" in body


def test_dashboard_drilldown(dashboards):
    def drill(base):
        root = f"{base}/engine_instances/ev1"
        return (_call(f"{root}/evaluator_results.txt", raw=True),
                _call(f"{root}/evaluator_results.html", raw=True),
                _call(f"{root}/evaluator_results.json"),
                _call(root))

    txt, html, js, bare = _both(dashboards, drill)
    assert txt == (200, "[0.5] RMSE")
    assert html[1].startswith("<html>")
    assert js == bare == (200, {"bestScore": 0.5})


def test_dashboard_unknown_404(dashboards):
    def unknown(base):
        return [_call(f"{base}{p}", raw=True)[0] for p in (
            "/engine_instances/nope/evaluator_results.txt",
            "/engine_instances/ev1/other.txt", "/nope", "/a/b/c/d")]

    assert _both(dashboards, unknown) == [404] * 4


PAGES = ("/", "/metrics.html", "/events.html?app=1", "/xray.html",
         "/pulse.html", "/train.html", "/tenants.html", "/experiments.html",
         "/fleet.html", "/prof.html?seconds=5", "/metrics")


def test_every_page_answers(tmp_path):
    """Every page of the reference's ``do_GET`` answers 200 on the
    port's dashboard over a SQLite store; ``events.html`` lists the
    app's newest events through the rowid cursor; a bad query is 400."""
    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    es.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{k}",
              target_entity_type="item", target_entity_id=f"i{k}",
              properties={"rating": 4.0}) for k in range(3)], app.id)
    s = DashboardServer(st, port=0)
    s.start_background()
    try:
        base = f"http://127.0.0.1:{s.port}"
        for page in PAGES:
            status, body = _call(base + page, raw=True)
            assert status == 200, page
        _, events = _call(f"{base}/events.html?app={app.id}&n=2", raw=True)
        assert "user/u2" in events and "user/u1" in events
        assert "user/u0" not in events
        assert _call(f"{base}/events.html?app=x", raw=True)[0] == 400
        _, index = _call(f"{base}/", raw=True)
        assert f"/events.html?app={app.id}'>shop" in index
    finally:
        s.stop()
        st.close()


def test_tenants_and_experiments_pages_show_live_tenants(tmp_path):
    """``tenants.html`` renders the port's tenant families per
    (app, variant) and the online A/B table; ``experiments.html`` the
    in-process autopilot's per-app state (the reference's rendering of
    each)."""
    from predictionio_tpu_torch.obs import (
        TENANT_QUERIES_TOTAL,
        TENANT_QUERY_LATENCY,
        VARIANT_REQUESTS_TOTAL,
    )
    from predictionio_tpu_torch.tenancy import autopilot

    TENANT_QUERIES_TOTAL.labels(app="dashapp", variant="treat",
                                status="ok").inc(3)
    TENANT_QUERY_LATENCY.labels(app="dashapp", variant="treat").observe(
        0.004)
    VARIANT_REQUESTS_TOTAL.labels(app="dashapp", variant="treat").inc(5)
    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    s = DashboardServer(st, port=0)
    s.start_background()
    payload = {"enabled": True, "manifestId": "pilot-x", "ticks": 4,
               "config": {"alpha": 0.05}, "weights": {"dashapp": {
                   "control": 0.4, "treat": 0.6}},
               "apps": {"dashapp": {"stateName": "ramping", "last": {
                   "decision": "ramp", "leader": "treat", "llr": 1.25,
                   "lower": -2.0, "upper": 2.9}, "decisions": [{
                       "decision": "ramp", "llr": 1.25,
                       "weights": {"treat": 0.6}}]}}}
    orig = autopilot.autopilot_payload
    autopilot.autopilot_payload = lambda: payload
    try:
        base = f"http://127.0.0.1:{s.port}"
        _, tenants = _call(f"{base}/tenants.html", raw=True)
        assert "dashapp/treat" in tenants
        assert "<td>5</td>" in tenants   # the impressions
        _, exp = _call(f"{base}/experiments.html", raw=True)
        assert "in-process autopilot" in exp and "dashapp" in exp
        assert "ramping" in exp and "1.250 in [-2.000, 2.900]" in exp
        assert "control=0.400, treat=0.600" in exp
        autopilot.autopilot_payload = lambda: None
        _, none = _call(f"{base}/experiments.html", raw=True)
        assert "No autopilot in this process" in none
    finally:
        autopilot.autopilot_payload = orig
        s.stop()
        st.close()
