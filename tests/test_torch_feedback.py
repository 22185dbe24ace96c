"""The port's feedback events, remote error log and HTML status page
against the JAX package's, on the CPU.

The JAX package trains an instance; its record is copied into a port
home and its model carried across with ``convert.model_from_jax``, so a
reference ``EngineServer`` and a port one serve the same instance id on
the same factors.  Both post their feedback events and error logs to
one capture stub (each to its own paths).  For the same queries, on both
edges: the feedback events are equal apart from the random ``prId``
(the predictions' scores within 1e-5 of their scale: both compute f32
dot products, in another order), each reply's ``prId`` is its event's
``entityId``, a traced query's ``X-PIO-Trace`` rides its feedback POST,
the remote-log bodies are byte-equal, and ``status_html`` carries the
same rows.  Every server and stub stops, and every fault plan is
disarmed, in ``finally``.
"""

import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from predictionio_tpu.controller.base import (
    WorkflowContext as JaxWorkflowContext,
)
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.server.serving import (
    EngineServer as JaxEngineServer,
    ServerConfig as JaxServerConfig,
)
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.workflow.train import (
    prepare_deploy as jax_prepare_deploy,
    run_train as jax_run_train,
)
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.server import EngineServer, ServerConfig
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.metadata import EngineInstance
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.model_io import save_models

N_USERS, N_ITEMS = 30, 20
VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 2, "lambda": 0.05, "seed": 1}}],
}
EDGES = ["eventloop", "threads"]


class Capture:
    """A stub collector: records each POST's path, body and trace header
    and answers 201."""

    def __init__(self):
        cap = self
        self.posts = []
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with cap.lock:
                    cap.posts.append((self.path, body,
                                      self.headers.get("X-PIO-Trace")))
                self.send_response(201)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def under(self, prefix: str) -> list:
        with self.lock:
            return [p for p in self.posts if p[0].startswith(prefix)]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


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
def homes(tmp_path_factory):
    """``(JAX home, port home, instance id)``: an instance the JAX
    package trained, and the same instance (record and model, the model
    through ``model_from_jax``) in a port home."""
    jhome = tmp_path_factory.mktemp("jax-home")
    phome = tmp_path_factory.mktemp("port-home")
    st = Storage({"PIO_TPU_HOME": str(jhome)})
    _seed_events(st)
    st.close()
    jst = JaxStorage({"PIO_TPU_HOME": str(jhome)})
    jengine = jax_recommendation_engine()
    jctx = JaxWorkflowContext(storage=jst)
    iid = jax_run_train(jengine, jengine.params_from_variant(VARIANT),
                        ctx=jctx)
    rec = jst.get_metadata().engine_instance_get(iid)
    (jmodel,) = jax_prepare_deploy(
        jengine, jengine.params_from_instance(rec), iid,
        JaxWorkflowContext(storage=jst, mode="Serving"))
    jst.close()
    pst = Storage({"PIO_TPU_HOME": str(phome)})
    try:
        pst.get_metadata().engine_instance_insert(
            EngineInstance(**dataclasses.asdict(rec)))
        engine = recommendation_engine()
        ctx = WorkflowContext(device="cpu", storage=pst)
        (algo,) = engine._algorithms(engine.params_from_instance(rec))
        save_models(ctx, iid, [("als", algo, model_from_jax(jmodel, "cpu"))])
    finally:
        pst.close()
    return jhome, phome, iid


@pytest.fixture()
def capture():
    cap = Capture()
    try:
        yield cap
    finally:
        cap.stop()


def _server(name, homes, edge, capture):
    jhome, phome, iid = homes
    cfg = dict(port=0, edge=edge, feedback=True,
               event_server_url=f"{capture.base}/{name}",
               access_key="fbkey", log_url=f"{capture.base}/{name}-log",
               log_prefix="pio-log ")
    if name == "port":
        st = Storage({"PIO_TPU_HOME": str(phome)})
        engine = recommendation_engine()
        rec = st.get_metadata().engine_instance_get(iid)
        srv = EngineServer(
            engine, engine.params_from_instance(rec), iid,
            ctx=WorkflowContext(device="cpu", storage=st, mode="Serving"),
            config=ServerConfig(**cfg))
    else:
        st = JaxStorage({"PIO_TPU_HOME": str(jhome)})
        engine = jax_recommendation_engine()
        rec = st.get_metadata().engine_instance_get(iid)
        srv = JaxEngineServer(
            engine, engine.params_from_instance(rec), iid,
            ctx=JaxWorkflowContext(storage=st, mode="Serving"),
            config=JaxServerConfig(**cfg))
    srv.start_background()
    return srv, st, f"http://127.0.0.1:{srv.port}"


def _req(url, payload=None, raw=None, headers=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _queries(n: int = 8) -> list:
    rng = np.random.default_rng(4)
    return [{"user": f"u{int(rng.integers(N_USERS + 2))}",
             "num": int(rng.integers(1, 5))} for _ in range(n)]


def _drive(name, homes, edge, capture, plan=None) -> dict:
    """Serve the queries (one traced), one invalid query and one that
    fails to decode; flush both queues; what the server answered and
    what reached the stub."""
    srv, st, base = _server(name, homes, edge, capture)
    armed = {"jax": jax_faults, "port": faults}[name]
    try:
        if plan:
            armed.arm(plan)
        replies = []
        for k, q in enumerate(_queries()):
            hdrs = {"X-PIO-Trace": f"t-fb-{k}"} if k == 3 else None
            code, body, _ = _req(base + "/queries.json", q, headers=hdrs)
            assert code == 200
            replies.append(json.loads(body))
        assert _req(base + "/queries.json", {"num": 3})[0] == 400
        code, html, hdrs = _req(base + "/", headers={"Accept": "text/html"})
        assert code == 200 and hdrs["Content-Type"].startswith("text/html")
        assert srv._feedback_queue.flush(30) and srv._log_queue.flush(30)
        status = json.loads(_req(base + "/")[1])
        return {"replies": replies,
                "events": capture.under(f"/{name}/"),
                "logs": capture.under(f"/{name}-log"),
                "html": html.decode(), "status": status}
    finally:
        armed.disarm()
        srv.stop()
        st.close()


def _same_prediction(got: dict, want: dict) -> None:
    assert [s["item"] for s in got["itemScores"]] == [
        s["item"] for s in want["itemScores"]]
    g = np.array([s["score"] for s in got["itemScores"]], np.float64)
    w = np.array([s["score"] for s in want["itemScores"]], np.float64)
    scale = max(1.0, float(np.abs(w).max(initial=0.0)))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("edge", EDGES)
def test_feedback_events_equal_the_references(homes, capture, edge):
    got = {name: _drive(name, homes, edge, capture)
           for name in ("jax", "port")}
    for name, out in got.items():
        assert len(out["events"]) == len(out["replies"]) == 8
        for reply, (path, body, _) in zip(out["replies"], out["events"]):
            assert path == f"/{name}/events.json?accessKey=fbkey"
            event = json.loads(body)
            assert event["entityId"] == reply["prId"]
    for k, ((jp, jb, jt), (pp, pb, pt), q) in enumerate(zip(
            got["jax"]["events"], got["port"]["events"], _queries())):
        je, pe = json.loads(jb), json.loads(pb)
        assert pe["properties"]["query"] == je["properties"]["query"] == q
        _same_prediction(pe["properties"]["prediction"],
                         je["properties"]["prediction"])
        for e in (je, pe):
            del e["entityId"], e["properties"]["prediction"]
        assert pe == je
        # the client's trace id, or one the edge minted
        assert pt == jt == "t-fb-3" if k == 3 else pt and jt
    for jr, pr in zip(got["jax"]["replies"], got["port"]["replies"]):
        _same_prediction(pr, jr)
        assert set(pr) == set(jr)


@pytest.mark.parametrize("edge", EDGES)
def test_remote_log_bodies_are_byte_equal(homes, capture, edge):
    got = {name: _drive(name, homes, edge, capture)
           for name in ("jax", "port")}
    assert [b for _, b, _ in got["port"]["logs"]] == [
        b for _, b, _ in got["jax"]["logs"]]
    (body,) = [b for _, b, _ in got["port"]["logs"]]
    assert body.startswith(b"pio-log {")
    msg = json.loads(body[len(b"pio-log "):])["message"]
    assert msg.startswith("Query is invalid" if edge == "eventloop"
                          else 'Query {"num": 3} is invalid')
    assert json.loads(body[8:])["engineInstance"]["id"] == homes[2]


def _rows(html: str) -> dict:
    return dict(re.findall(r"<tr><th>(.*?)</th><td>(.*?)</td></tr>", html))


@pytest.mark.parametrize("edge", EDGES)
def test_status_html_and_json_carry_the_same_fields(homes, capture, edge):
    got = {name: _drive(name, homes, edge, capture)
           for name in ("jax", "port")}
    rows = {name: _rows(out["html"]) for name, out in got.items()}
    assert list(rows["port"]) == list(rows["jax"])
    timing = {"Start Time", "Average Serving Time", "Last Serving Time",
              "Serving Time p50 / p95 / p99",
              "Slowest Requests (flight recorder)"}
    for key in set(rows["jax"]) - timing:
        assert rows["port"][key] == rows["jax"][key], key
    assert rows["port"]["Instance ID"] == homes[2]
    assert rows["port"]["Request Count"] == "8"
    blocks = {name: {k: out["status"]["resilience"][k]
                     for k in ("feedback", "remoteLog")}
              for name, out in got.items()}
    assert blocks["port"] == blocks["jax"]
    fb = blocks["port"]["feedback"]
    assert (fb["submitted"], fb["delivered"], fb["dropped"]) == (8, 8, 0)


@pytest.mark.parametrize("point", ["http.feedback", "http.remote_log"])
def test_delivery_faults_fail_no_query(homes, capture, point):
    plan = f"seed=11;{point}:prob=0.5"
    got = {name: _drive(name, homes, "eventloop", capture, plan=plan)
           for name in ("jax", "port")}
    key = "feedback" if point == "http.feedback" else "remoteLog"
    stats = {name: out["status"]["resilience"][key]
             for name, out in got.items()}
    assert stats["port"] == stats["jax"]
    st = stats["port"]
    assert st["delivered"] + st["dropped"] == st["submitted"] == (
        8 if key == "feedback" else 1)
    assert len(got["port"]["replies"]) == 8
