"""The ring top-k in serving against the JAX package's, on the CPU.

Mirrors the ring half of ``tests/test_chaos_distributed.py`` (the
deadline degrade, the sticky kill, the template's ``distributedTopk``)
and the int8 index's degraded path: the reference runs on
``make_mesh(4)``, the port on four CPU shards, both from the same numpy
factors made from a seed, under the same ``PIO_FAULT_PLAN`` rule armed
in each package's fault module.  Values within 1e-5 (the reference
test's tolerance), items in the same order (no ties in these inputs).
The port's ``EngineServer`` deployed with ``"distributedTopk": true``
answers ``/queries.json`` as in-process ``predict`` and carries the
index's ``distributedTopk`` block in its status.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.live.apply import (
    apply_model_delta as jax_apply_model_delta,
)
from predictionio_tpu.ops.distributed_topk import (
    ShardedTopK as JaxShardedTopK,
)
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu.resilience import (
    Deadline as JaxDeadline,
    deadline_scope as jax_deadline_scope,
    faults as jax_faults,
)
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSModel as JaxALSModel,
    Query as JaxQuery,
)
from predictionio_tpu.workflow.model_io import ModelDelta as JaxModelDelta
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.live.apply import apply_model_delta
from predictionio_tpu_torch.obs import SHARD_DEGRADED_TOTAL, get_tracer
from predictionio_tpu_torch.ops.distributed_topk import ShardedTopK
from predictionio_tpu_torch.parallel import make_mesh
from predictionio_tpu_torch.resilience import Deadline, deadline_scope, faults
from predictionio_tpu_torch.server import EngineServer, ServerConfig
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import prepare_deploy, run_train
from predictionio_tpu_torch.workflow.model_io import ModelDelta

D = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=["cpu"] * D)


def _table(seed, m, r):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, r))
            * rng.uniform(0.2, 2.0, size=(m, 1))).astype(np.float32)


def _same(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _both(plan, port_call, ref_call):
    """Each package's call under the same fault rule."""
    faults.arm(plan)
    try:
        got = port_call()
    finally:
        faults.disarm()
    jax_faults.arm(plan)
    try:
        want = ref_call()
    finally:
        jax_faults.disarm()
    return got, want


def test_deadline_degrade_returns_in_budget(meshes):
    """A shard whose injected lag dwarfs the request deadline is served
    from parity: the call returns without waiting out the lag, its
    answer is the clean one (parity current) and the reference's, and
    one degradation is booked, with a ``dist.parity_serve`` span."""
    jm, tm = meshes
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    v = _table(2, 50, 8)
    idx, ref = ShardedTopK(v, tm), JaxShardedTopK(v, jm)
    clean = idx(q, 7)
    _same(clean, ref(q, 7))
    before = SHARD_DEGRADED_TOTAL.labels(shard="3").value()
    n_spans = len(get_tracer().spans())
    plan = "dist.shard_delay:shard=3,delay=30.0,times=1"
    t0 = time.perf_counter()
    got, want = _both(
        plan,
        lambda: _in_scope(deadline_scope, Deadline, lambda: idx(q, 7)),
        lambda: _in_scope(jax_deadline_scope, JaxDeadline,
                          lambda: ref(q, 7)))
    assert time.perf_counter() - t0 < 15.0
    _same(got, want)
    _same(got, clean)
    assert int(got[1].max()) < 50   # padding rows never win
    assert SHARD_DEGRADED_TOTAL.labels(shard="3").value() == before + 1
    spans = [s for s in get_tracer().spans()[n_spans:]
             if s.name == "dist.parity_serve"]
    assert spans and spans[0].attrs["shard"] == 3
    assert idx.summary() == ref.summary()
    assert idx.summary()["degradedPolls"] == 1


def _in_scope(scope, deadline, call):
    with scope(deadline.after(0.4)):
        return call()


def test_killed_shard_stays_killed_across_requests(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6)).astype(np.float32)
    v = _table(3, 24, 6)
    idx, ref = ShardedTopK(v, tm), JaxShardedTopK(v, jm)
    clean = idx(q, 5)
    _same(clean, ref(q, 5))
    got, want = _both("dist.worker_kill:shard=2,times=1",
                      lambda: idx(q, 5), lambda: ref(q, 5))
    _same(got, want)
    # no plan armed: the kill persists
    again = idx(q, 5)
    _same(again, ref(q, 5))
    _same(again, clean)
    assert idx.health.killed == ref.health.killed == {2}
    assert idx.summary() == ref.summary()
    assert idx.summary()["degradedPolls"] == 2


def test_degraded_int8_index_rides_the_coded_exact_ring(meshes):
    """With a shard down the int8 index answers exactly (the coded exact
    ring), as the reference's; clean, it answers the reference's int8
    ring."""
    jm, tm = meshes
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    v = _table(5, 64, 8)
    idx = ShardedTopK(v, tm, retrieval="ivf", candidate_factor=2)
    ref = JaxShardedTopK(v, jm, retrieval="ivf", candidate_factor=2)
    assert idx.retrieval == ref.retrieval == "int8"
    _same(idx(q, 4), ref(q, 4))
    got, want = _both("dist.shard_drop:shard=1,times=1",
                      lambda: idx(q, 4), lambda: ref(q, 4))
    _same(got, want)
    dense = q @ v.T
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.argsort(-dense, axis=1)[:, :4])
    assert idx.summary() == ref.summary()


N_USERS, N_ITEMS, RANK = 12, 42, 6


def _models(seed=6):
    rng = np.random.default_rng(seed)
    jmodel = JaxALSModel(
        user_factors=rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        item_factors=_table(seed + 1, N_ITEMS, RANK),
        users=JaxStringIndex([f"u{k}" for k in range(N_USERS)]),
        items=JaxStringIndex([f"i{k}" for k in range(N_ITEMS)]),
        item_props={f"i{k}": {"categories": ["even" if k % 2 else "odd"]}
                    for k in range(N_ITEMS)},
    )
    return jmodel, model_from_jax(jmodel, "cpu")


def _algos(**params):
    port, ref = ALSAlgorithm(), JaxALSAlgorithm()
    port.params = port.params_class(distributed_topk=True, **params)
    ref.params = ref.params_class(distributed_topk=True, **params)
    return port, ref


def _items(result):
    return [(s.item, s.score) for s in result.item_scores]


def _same_items(got, want):
    g, w = _items(got), _items(want)
    assert [i for i, _ in g] == [i for i, _ in w]
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], **TOL)


QUERIES = ([dict(user=f"u{k}", num=n)
            for k, n in ((0, 10), (1, 4), (2, 1), (3, 50), (5, 7))]
           + [dict(user="u4", num=6, categories=("even",)),
              dict(user="u6", num=5, blacklist=("i1", "i2")),
              dict(user="nobody", num=5), dict(user="u7", num=0)])


@pytest.mark.parametrize("retrieval", ["exact", "int8"])
def test_template_predict_and_batch_predict_match_the_reference(
        meshes, retrieval):
    """``distributedTopk`` in the template: unfiltered queries ride the
    ring (filtered ones the exact scorer), solo and batched, under a
    deadline with a shard delayed past it too; the reference's items,
    each over a four-shard index."""
    jm, tm = meshes
    jmodel, model = _models()
    port, ref = _algos(retrieval=retrieval, candidate_factor=3)
    ctx = WorkflowContext(device="cpu", storage=object(), mesh=tm)
    port._ctx = ctx
    jmodel._sharded_topk = JaxShardedTopK(
        jmodel.item_factors, jm, retrieval=retrieval, candidate_factor=3)
    port.warmup(model, max_batch=8)
    assert model._sharded_topk.mesh is tm
    assert model._sharded_topk.summary() == jmodel._sharded_topk.summary()
    for q in QUERIES:
        _same_items(port.predict(model, Query(**q)),
                    ref.predict(jmodel, JaxQuery(**q)))
    got = port.batch_predict(model, [Query(**q) for q in QUERIES])
    want = ref.batch_predict(jmodel, [JaxQuery(**q) for q in QUERIES])
    for g, w in zip(got, want):
        _same_items(g, w)
    plan = "dist.shard_delay:shard=1,delay=30.0,times=1"
    g, w = _both(
        plan,
        lambda: _in_scope(deadline_scope, Deadline, lambda: port.predict(
            model, Query(user="u1", num=6))),
        lambda: _in_scope(jax_deadline_scope, JaxDeadline,
                          lambda: ref.predict(jmodel,
                                              JaxQuery(user="u1", num=6))))
    _same_items(g, w)
    assert model._sharded_topk.summary()["degradedPolls"] == 1


def test_a_foldin_delta_leaves_the_ring_index_stale_as_the_reference(
        meshes):
    """A fold-in delta patches the device tables but not the ring
    index, in both packages: the ring keeps serving the rows it was
    built from until the next load (ROADMAP: faults of the reference)."""
    jm, tm = meshes
    jmodel, model = _models(seed=9)
    port, ref = _algos()
    model.sharded_topk_index(mesh=tm)
    jmodel._sharded_topk = JaxShardedTopK(jmodel.item_factors, jm)
    before = _items(port.predict(model, Query(user="u0", num=5)))
    top = int(model.items.get(before[0][0]))
    rows = -np.abs(model.item_factors[[top]]) * 10
    delta = dict(seq=1, user_rows_ix=np.zeros(0, np.int32),
                 user_rows=np.zeros((0, RANK), np.float32),
                 item_rows_ix=np.array([top], np.int32), item_rows=rows,
                 new_user_ids=[], new_user_rows=np.zeros((0, RANK),
                                                         np.float32),
                 new_item_ids=[], new_item_rows=np.zeros((0, RANK),
                                                         np.float32),
                 meta={"baseUsers": N_USERS, "baseItems": N_ITEMS})
    apply_model_delta(model, ModelDelta(**delta))
    jax_apply_model_delta(jmodel, JaxModelDelta(**delta))
    assert np.array_equal(model.item_factors[top], rows[0])
    after = port.predict(model, Query(user="u0", num=5))
    assert _items(after) == before
    _same_items(after, ref.predict(jmodel, JaxQuery(user="u0", num=5)))


VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 2, "lambda": 0.05, "seed": 1,
        "solver": "fused", "distributedTopk": True}}],
}


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("edge", ["eventloop", "threads"])
def test_the_edge_answers_as_predict_and_reports_the_ring(tmp_path, meshes,
                                                          edge):
    """An engine deployed with ``"distributedTopk": true`` over a
    context carrying a four-shard mesh: every ``/queries.json`` reply
    equals in-process ``predict``, and ``GET /`` carries the index's
    ``distributedTopk`` block."""
    _, tm = meshes
    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    rng = np.random.default_rng(0)
    u, i = np.nonzero(rng.random((20, 30)) < 0.4)
    es.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(rng.integers(1, 11) * 0.5)})
        for a, b in zip(u.tolist(), i.tolist())], app.id)
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        iid = run_train(engine, ep,
                        ctx=WorkflowContext(device="cpu", storage=st))
        ctx = WorkflowContext(device="cpu", storage=st, mode="Serving",
                              mesh=tm)
        srv = EngineServer(engine, ep, iid, ctx=ctx,
                           config=ServerConfig(port=0, edge=edge))
        srv.start_background()
        try:
            (model,) = prepare_deploy(engine, ep, iid, WorkflowContext(
                device="cpu", storage=st))
            algo = ALSAlgorithm()
            algo.params = ep.algorithms[0][1]
            for q in ({"user": "u1", "num": 4}, {"user": "u3", "num": 30},
                      {"user": "u5", "num": 3, "blackList": ["i1"]},
                      {"user": "zz", "num": 3}):
                got = _post(srv.port, q)
                want = algo.predict(model, Query.from_json(q)).to_json()
                assert [s["item"] for s in got["itemScores"]] == [
                    s["item"] for s in want["itemScores"]]
                np.testing.assert_allclose(
                    [s["score"] for s in got["itemScores"]],
                    [s["score"] for s in want["itemScores"]], **TOL)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/", timeout=30) as r:
                status = json.loads(r.read())
            block = status["distributedTopk"]
            assert (block["items"], block["shards"], block["retrieval"],
                    block["killed"]) == (30, D, "exact", [])
        finally:
            srv.stop()
    finally:
        torch.set_num_threads(threads)
        st.close()
