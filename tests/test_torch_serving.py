"""The port's ``EngineServer`` on the CPU, against the JAX template.

A model is trained with ``run_train`` from events in a scratch
``$PIO_TPU_HOME``; the port's server (threads edge, port 0, CPU) serves
it, and every ``/queries.json`` reply must carry the JSON the JAX
template's ``predict(...).to_json()`` gives on the same factors: the
same items in the same order, scores within 1e-5 of their scale (both
compute f32 dot products, in another order).  Solo and with 16
concurrent clients (coalesced by the micro-batcher).  Bad requests get
400, unknown paths 404.
"""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import instantiate as jax_instantiate
from predictionio_tpu.server.microbatch import (
    dispatchable_sizes as jax_dispatchable_sizes,
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
    AdmissionRejected,
    EngineServer,
    MicroBatcher,
    ServerConfig,
    dispatchable_sizes,
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
    """(engine, params, instance id, storage, JAX algorithm, JAX model):
    an instance trained from seeded rate events, and the JAX template
    holding the same factors."""
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


@pytest.fixture
def server(deployed):
    engine, ep, iid, st = deployed[:4]
    srv = EngineServer(engine, ep, iid,
                       ctx=WorkflowContext(device="cpu", storage=st,
                                           mode="Serving"),
                       config=ServerConfig(port=0, edge="threads"))
    thread = srv.start_background()
    yield srv
    srv.stop()
    thread.join(timeout=10)


def _post(port, path, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


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


def test_solo_queries_answer_like_the_jax_template(deployed, server):
    queries = _queries(24, seed=1)
    for q in queries:
        code, got = _post(server.port, "/queries.json",
                          json.dumps(q).encode())
        assert code == 200, got
        _same_json(got, _jax_json(deployed, q))
    assert server.status_json()["requestCount"] == len(queries)


def test_concurrent_queries_answer_like_the_jax_template(deployed, server):
    queries = _queries(64, seed=2)
    with ThreadPoolExecutor(max_workers=16) as pool:
        replies = list(pool.map(
            lambda q: _post(server.port, "/queries.json",
                            json.dumps(q).encode()), queries))
    for q, (code, got) in zip(queries, replies):
        assert code == 200, got
        _same_json(got, _jax_json(deployed, q))
    stats = server.status_json()["microbatch"]
    assert stats["requests"] == len(queries)


def test_microbatch_off_gives_the_same_answers(deployed):
    engine, ep, iid, st = deployed[:4]
    srv = EngineServer(engine, ep, iid,
                       ctx=WorkflowContext(device="cpu", storage=st,
                                           mode="Serving"),
                       config=ServerConfig(port=0, microbatch="off"))
    assert srv.batcher is None
    for q in _queries(8, seed=3):
        _same_json(srv.predict_json(q), _jax_json(deployed, q))


def test_bad_requests_get_400_and_unknown_paths_404(server):
    code, body = _post(server.port, "/queries.json", b"{not json")
    assert code == 400 and "invalid JSON" in body["message"]
    code, body = _post(server.port, "/queries.json", b'{"num": 3}')
    assert code == 400 and "bad query" in body["message"]
    code, _ = _post(server.port, "/queries.json?timeout=soon", b"{}")
    assert code == 400
    assert _post(server.port, "/nowhere", b"{}")[0] == 404
    assert _get(server.port, "/nowhere")[0] == 404


def test_status_reload_and_stop(deployed, server):
    code, status = _get(server.port, "/")
    assert code == 200 and status["status"] == "alive"
    assert status["engineInstanceId"] == deployed[2]
    assert status["device"] == "cpu"
    code, body = _get(server.port, "/reload")
    assert code == 200 and body["reloaded"] == deployed[2]
    code, body = _post(server.port, "/stop", b"")
    assert code == 200 and body["message"] == "stopping"
    # its owner's stop() returns once the server is gone
    server.stop()
    with pytest.raises(urllib.error.URLError, match="refused"):
        _get(server.port, "/")


def test_unported_edges_are_refused():
    # the reference's default edge and batcher are the port's too; the
    # threads edge stays selectable, an unknown edge raises; feedback is
    # taken with the reference's delivery defaults
    assert ServerConfig().edge == "eventloop"
    assert ServerConfig().shared_batcher is True
    assert ServerConfig(edge="threads").edge == "threads"
    cfg = ServerConfig(feedback=True, event_server_url="http://h:7070")
    assert (cfg.feedback, cfg.event_server_url, cfg.feedback_capacity,
            cfg.breaker_failures, cfg.breaker_reset_s) == (
        True, "http://h:7070", 1024, 5, 10.0)
    with pytest.raises(ValueError, match="edge"):
        ServerConfig(edge="asyncio")


def test_micro_batcher_coalesces_and_pads():
    for n in (0, 1, 5, 64, 100):
        assert dispatchable_sizes(n) == jax_dispatchable_sizes(n)
    seen = []

    def batch_fn(items):
        seen.append(len(items))
        return [x * 2 for x in items]

    mb = MicroBatcher(batch_fn, max_batch=8)
    with ThreadPoolExecutor(max_workers=8) as pool:
        out = list(pool.map(mb.submit, range(40)))
    assert out == [2 * x for x in range(40)]
    assert sum(seen) >= 40 and max(seen) <= 8
    assert issubclass(AdmissionRejected, TimeoutError)
    mb.close()
