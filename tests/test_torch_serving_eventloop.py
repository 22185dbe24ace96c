"""The port's ``EngineServer`` on its default event-loop edge, and its
shared batcher, against the JAX package.

The JAX template's model (factors trained by the port's ``run_train``
from seeded events, carried across into the JAX ``ALSModel``) is served
by the port's ``EngineServer(edge="eventloop")`` on the CPU; every
``/queries.json`` reply must carry the JSON the JAX template's
``predict(...).to_json()`` gives: the same items in the same order,
scores within 1e-5 of their scale.  Solo, from 64 concurrent clients
(coalesced by the shared batcher, or by a private one), and with the
batcher off (the aux pool's direct path).  Error replies carry the
reference's bodies.  The ``SharedBatcher`` itself is driven through the
same gated schedule as the JAX one (equal and pushed weights): the same
batches, the same results, the same claims.
"""

import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import instantiate as jax_instantiate
from predictionio_tpu.server.microbatch import (
    SharedBatcher as JaxSharedBatcher,
    SharedBatcherView as JaxSharedBatcherView,
)
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxALSAlgorithmParams,
    ALSModel as JaxALSModel,
    Query as JaxQuery,
)
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.server import (
    EngineServer,
    ServerConfig,
    SharedBatcher,
    SharedBatcherView,
)
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import prepare_deploy, run_train

N_USERS, N_ITEMS = 40, 25
VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1,
        "solver": "fused"}}],
}
BATCHERS = {
    "jax": (JaxSharedBatcher, JaxSharedBatcherView),
    "torch": (SharedBatcher, SharedBatcherView),
}


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(N_ITEMS)]
    out = []
    for k in range(n):
        q = {"user": f"u{int(rng.integers(0, N_USERS + 3))}",
             "num": int(rng.integers(0, N_ITEMS + 2))}
        if k % 4 == 1:
            q["categories"] = ["even"]
        elif k % 4 == 2:
            q["whiteList"] = [str(x) for x in rng.choice(items, 6, False)]
        elif k % 4 == 3:
            q["blackList"] = [str(x) for x in rng.choice(items, 4, False)]
        out.append(q)
    return out


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """(engine, params, instance id, storage, JAX algorithm, JAX model)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    home = tmp_path_factory.mktemp("home")
    st = Storage({"PIO_TPU_HOME": str(home)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    rng = np.random.default_rng(0)
    u, i = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.4)
    es.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(rng.integers(1, 11) * 0.5)})
        for a, b in zip(u.tolist(), i.tolist())
    ] + [
        Event(event="$set", entity_type="item", entity_id=f"i{j}",
              properties={"categories": ["even" if j % 2 == 0 else "odd"]})
        for j in range(N_ITEMS)
    ], app.id)
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    iid = run_train(engine, ep, ctx=WorkflowContext(device="cpu", storage=st))
    (model,) = prepare_deploy(engine, ep, iid,
                              WorkflowContext(device="cpu", storage=st))
    jalgo = jax_instantiate(JaxALSAlgorithm, JaxALSAlgorithmParams())
    jmodel = JaxALSModel(
        user_factors=model.user_factors, item_factors=model.item_factors,
        users=JaxStringIndex(list(model.users.ids)),
        items=JaxStringIndex(list(model.items.ids)),
        item_props=model.item_props,
    )
    yield engine, ep, iid, st, jalgo, jmodel
    st.close()
    torch.set_num_threads(threads)


def _serve(deployed, **config):
    engine, ep, iid, st = deployed[:4]
    srv = EngineServer(engine, ep, iid,
                       ctx=WorkflowContext(device="cpu", storage=st,
                                           mode="Serving"),
                       config=ServerConfig(port=0, **config))
    return srv, srv.start_background()


@pytest.fixture
def server(deployed):
    srv, thread = _serve(deployed)
    yield srv
    srv.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(port, method, path, body=None):
    """(status, headers, JSON reply) over a fresh connection."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body,
                  {"Content-Type": "application/json"} if body else {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        c.close()


def _post(port, path, body: bytes):
    code, _, reply = _request(port, "POST", path, body)
    return code, reply


def _same_json(got: dict, want: dict) -> None:
    assert [s["item"] for s in got["itemScores"]] == \
        [s["item"] for s in want["itemScores"]]
    g = np.array([s["score"] for s in got["itemScores"]])
    w = np.array([s["score"] for s in want["itemScores"]])
    assert np.abs(g - w).max(initial=0.0) <= 1e-5 * max(
        np.abs(w).max(initial=0.0), 1.0)


def _jax_json(deployed, q):
    jalgo, jmodel = deployed[4:]
    return jalgo.predict(jmodel, JaxQuery.from_json(q)).to_json()


def test_defaults_are_the_event_loop_edge_and_shared_batcher(server):
    assert server.config.edge == "eventloop"
    assert isinstance(server.batcher, SharedBatcherView)
    assert type(server._httpd).__name__ == "EventLoopHTTPServer"


def test_solo_queries_answer_like_the_jax_template(deployed, server):
    queries = _queries(24, seed=1)
    for q in queries:
        code, got = _post(server.port, "/queries.json",
                          json.dumps(q).encode())
        assert code == 200, got
        _same_json(got, _jax_json(deployed, q))
    status = server.status_json()
    assert status["requestCount"] == len(queries)
    assert status["microbatch"]["dispatched"] == len(queries)


def test_64_concurrent_clients_answer_like_the_jax_template(deployed, server):
    queries = _queries(256, seed=2)
    with ThreadPoolExecutor(max_workers=64) as pool:
        replies = list(pool.map(
            lambda q: _post(server.port, "/queries.json",
                            json.dumps(q).encode()), queries))
    for q, (code, got) in zip(queries, replies):
        assert code == 200, got
        _same_json(got, _jax_json(deployed, q))
    stats = server.status_json()["microbatch"]
    assert stats["requests"] == stats["dispatched"] == len(queries)
    assert stats["shared"] and stats["tenantsRegistered"] == 1


def test_private_batcher_answers_like_the_jax_template(deployed):
    srv, thread = _serve(deployed, shared_batcher=False)
    try:
        assert type(srv.batcher).__name__ == "MicroBatcher"
        queries = _queries(128, seed=5)
        with ThreadPoolExecutor(max_workers=64) as pool:
            replies = list(pool.map(
                lambda q: _post(srv.port, "/queries.json",
                                json.dumps(q).encode()), queries))
        for q, (code, got) in zip(queries, replies):
            assert code == 200, got
            _same_json(got, _jax_json(deployed, q))
        stats = srv.status_json()["microbatch"]
        assert stats["dispatched"] == len(queries)
        assert "shared" not in stats
    finally:
        srv.stop()
        thread.join(timeout=10)


def test_batcher_off_answers_on_the_aux_pool_like_the_jax_template(deployed):
    srv, thread = _serve(deployed, microbatch="off")
    try:
        assert srv.batcher is None
        for q in _queries(8, seed=3):
            code, got = _post(srv.port, "/queries.json",
                              json.dumps(q).encode())
            assert code == 200, got
            _same_json(got, _jax_json(deployed, q))
    finally:
        srv.stop()
        thread.join(timeout=10)


def test_error_replies_carry_the_reference_bodies(deployed, server):
    """400s, 404, 405 and the admission 503 on the event-loop edge carry
    the bodies the threads edge (and the reference) give."""
    threads, t_thread = _serve(deployed, edge="threads")
    try:
        for path, body in (("/queries.json", b"{not json"),
                           ("/queries.json", b'{"num": 3}'),
                           ("/queries.json?timeout=soon", b"{}"),
                           ("/nowhere", b"{}")):
            got = _post(server.port, path, body)
            assert got == _post(threads.port, path, body)
            assert got[0] in (400, 404)
        assert _post(server.port, "/queries.json", b"{not json")[1][
            "message"].startswith("invalid JSON: ")
        assert _post(server.port, "/queries.json?timeout=soon", b"{}") == (
            400, {"message": "bad timeout: 'soon'"})
        assert _request(server.port, "GET", "/nowhere")[::2] == (
            404, {"message": "not found"})
        assert _request(server.port, "PUT", "/queries.json", b"{}")[::2] == (
            405, {"message": "method PUT not allowed"})
        for srv in (server, threads):
            code, headers, reply = _request(
                srv.port, "POST", "/queries.json?timeout=0",
                b'{"user": "u1", "num": 3}')
            assert (code, headers["Retry-After"], reply["error"]) == (
                503, "1", "AdmissionRejected")
    finally:
        threads.stop()
        t_thread.join(timeout=10)


def test_status_reload_and_stop(deployed, server):
    code, _, status = _request(server.port, "GET", "/")
    assert code == 200 and status["status"] == "alive"
    assert status["engineInstanceId"] == deployed[2]
    assert status["device"] == "cpu"
    old = server.batcher
    code, _, body = _request(server.port, "GET", "/reload")
    assert code == 200 and body["reloaded"] == deployed[2]
    # the reload swapped in a new view and retired the old one
    assert server.batcher is not old
    with pytest.raises(RuntimeError, match="closed"):
        old.submit_nowait({}, lambda e: None)
    assert server.status_json()["microbatch"]["tenantsRegistered"] == 1
    q = _queries(1, seed=4)[0]
    code, got = _post(server.port, "/queries.json", json.dumps(q).encode())
    assert code == 200
    _same_json(got, _jax_json(deployed, q))
    code, body = _post(server.port, "/stop", b"")
    assert code == 200 and body["message"] == "stopping"
    server.stop()
    with pytest.raises(OSError):
        _request(server.port, "GET", "/")


def _gated_run(kind, plan, max_batch=8, weights=None):
    """Drive a shared batcher of ``kind`` through a fixed schedule: the
    first entry's device call blocks until every other entry of
    ``plan`` (a list of tenant names) is queued by ``submit_nowait``.
    Returns (batches as lists of items, results by item, claims)."""
    Core, View = BATCHERS[kind]
    core = Core(max_batch=max_batch, pad_batches=False)
    entered, release = threading.Event(), threading.Event()
    batches = []

    def batch_fn(items):
        batches.append(list(items))
        if len(batches) == 1:
            entered.set()
            assert release.wait(10)
        return [x * 10 for x in items]

    views = {t: View(core, t, batch_fn) for t in dict.fromkeys(plan)}
    if weights:
        core.set_weights(weights)
    results, done = {}, threading.Event()

    def on_done(entry):
        results[entry.item] = entry.value
        if len(results) == len(plan):
            done.set()

    views[plan[0]].submit_nowait(0, on_done)
    assert entered.wait(10)
    for k, t in enumerate(plan[1:], start=1):
        views[t].submit_nowait(k, on_done)
    release.set()
    assert done.wait(10)
    claims = dict(core.stats()["tenantClaims"])
    core.close()
    return batches, results, claims


def test_shared_batcher_coalesces_like_the_jax_one():
    plan = ["a"] * 13
    out = {kind: _gated_run(kind, plan) for kind in BATCHERS}
    assert out["torch"] == out["jax"]
    batches, results, _ = out["torch"]
    assert [len(b) for b in batches] == [1, 8, 4]
    assert results == {k: 10 * k for k in range(13)}


@pytest.mark.parametrize("weights,second", [
    (None, [1, 12, 2, 13]),
    ({"whale": 1.0, "small": 3.0}, [12, 13, 1, 14]),
], ids=["equal", "weighted"])
def test_shared_batcher_round_robin_claims_like_the_jax_one(weights, second):
    # a whale tenant floods the queue; the weighted round-robin still
    # gives the small tenant its share of every claim
    plan = ["whale"] * 12 + ["small"] * 4
    out = {kind: _gated_run(kind, plan, max_batch=4, weights=weights)
           for kind in BATCHERS}
    assert out["torch"] == out["jax"]
    assert out["torch"][0][1] == second


def test_a_raising_callback_does_not_stall_the_dispatcher():
    for kind, (Core, View) in BATCHERS.items():
        core = Core(max_batch=4)
        view = View(core, "t", lambda items: [x + 1 for x in items])
        got, done = [], threading.Event()

        def boom(entry):
            raise RuntimeError("callback exploded")

        def ok(entry):
            got.append(entry.value)
            done.set()

        view.submit_nowait(1, boom)
        time.sleep(0.05)
        view.submit_nowait(2, ok)
        assert done.wait(10), kind
        assert got == [3]
        assert core.stats()["dispatcher"] is True
        core.close()
