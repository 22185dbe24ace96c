"""The slice end to end: the port's ``recommendation_engine()`` trains and
serves, and answers like the JAX template on the same factors.

The port trains on the CPU through the Engine DSL (data source reading
rate and ``$set`` events from an in-memory event store → identity
preparator → ``ALSAlgorithm.train`` → ``train_als``, with the kernels'
plain versions).  The JAX template then serves the port's
factors through its own ``predict``/``batch_predict``; the answers must
name the same items in the same order, with scores within 1e-5 of their
scale (both compute f32 dot products, in another order).

Tie-break rule: equal scores are ordered by the lower item index first,
which is how ``jax.lax.top_k`` orders them and what the port's
``ops.topk._top_k`` gives; a table with duplicated item rows checks it,
with ties inside the top k and across its last place.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import instantiate as jax_instantiate
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxALSAlgorithmParams,
    ALSModel as JaxALSModel,
    Query as JaxQuery,
)
from predictionio_tpu_torch.controller import ParamsError, WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.storage import Event, Storage, StringIndex
from predictionio_tpu_torch.templates.recommendation import (
    ALSModel,
    Query,
    recommendation_engine,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


N_USERS, N_ITEMS = 40, 25


def _memory_storage() -> Storage:
    """Event and metadata stores in memory (no files, no ``$HOME``)."""
    return Storage({
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })


def _store(seed=0):
    """A memory-backed storage with app "shop": rate events of a rank-3
    rating matrix and a ``$set`` of categories for every item."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(N_USERS, 3))
    V = rng.normal(size=(N_ITEMS, 3))
    mask = rng.random((N_USERS, N_ITEMS)) < 0.4
    u, i = np.nonzero(mask)
    v = np.clip(np.round((U @ V.T)[u, i] + 3.0), 1, 5)
    storage = _memory_storage()
    app = storage.get_metadata().app_insert("shop")
    es = storage.get_event_store()
    es.init_channel(app.id)
    events = [
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(r)})
        for a, b, r in zip(u.tolist(), i.tolist(), v.tolist())
    ]
    events += [
        Event(event="$set", entity_type="item", entity_id=f"i{j}",
              properties={"categories": ["even" if j % 2 == 0 else "odd"]})
        for j in range(N_ITEMS)
    ]
    es.insert_batch(events, app.id)
    return storage


def _train(solver, store=None):
    engine = recommendation_engine()
    ep = engine.params_from_variant({
        "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1,
            "solver": solver}}]})
    ctx = WorkflowContext(device="cpu", storage=store or _store())
    algos, models = engine.train_components(ctx, ep)
    return algos[0], models[0]


def _jax_side(model: ALSModel):
    algo = jax_instantiate(JaxALSAlgorithm, JaxALSAlgorithmParams())
    jm = JaxALSModel(
        user_factors=model.user_factors, item_factors=model.item_factors,
        users=JaxStringIndex(list(model.users.ids)),
        items=JaxStringIndex(list(model.items.ids)),
        item_props=model.item_props,
    )
    return algo, jm


QUERIES = [
    dict(user="u0", num=5),
    dict(user="u3", num=25),
    dict(user="u5", num=4, categories=("even",)),
    dict(user="u6", num=6, whitelist=("i1", "i2", "i3", "i9")),
    dict(user="u7", num=7, blacklist=("i0", "i4")),
    dict(user="nobody", num=3),
    dict(user="u8", num=0),
]


def _same(got, want):
    assert [s.item for s in got.item_scores] == \
        [s.item for s in want.item_scores]
    g = np.array([s.score for s in got.item_scores])
    w = np.array([s.score for s in want.item_scores])
    assert np.abs(g - w).max(initial=0.0) <= 1e-5 * max(
        np.abs(w).max(initial=0.0), 1.0)


@pytest.mark.parametrize("solver", ["pallas", "fused"])
def test_engine_train_then_serve_matches_jax_template(solver):
    algo, model = _train(solver)
    assert algo.train_report["solver"] == solver
    assert np.isfinite(model.user_factors).all()
    jalgo, jmodel = _jax_side(model)
    for q in QUERIES:
        _same(algo.predict(model, Query(**q)),
              jalgo.predict(jmodel, JaxQuery(**q)))
    got = algo.batch_predict(model, [Query(**q) for q in QUERIES])
    want = jalgo.batch_predict(jmodel, [JaxQuery(**q) for q in QUERIES])
    for g, w in zip(got, want):
        _same(g, w)
    # the port's own solo and batched paths agree
    for q, g in zip(QUERIES, got):
        _same(g, algo.predict(model, Query(**q)))


def test_warmup_and_json_round_trip():
    algo, model = _train("fused")
    algo.warmup(model, max_batch=8)
    q = Query.from_json({"user": "u2", "num": 3, "blackList": ["i1"]})
    assert q.blacklist == ("i1",)
    out = algo.predict(model, q).to_json()
    assert len(out["itemScores"]) == 3
    assert all(s["item"] != "i1" for s in out["itemScores"])
    u, i = model.users.get("u2"), model.items.get("i4")
    assert algo.predict_rating(model, "u2", "i4") == pytest.approx(
        float(model.user_factors[u] @ model.item_factors[i]))


def test_ties_go_to_the_lower_item_index():
    rng = np.random.default_rng(2)
    V = rng.normal(size=(N_ITEMS, 4)).astype(np.float32)
    V[3] = V[10] = V[20] = 5.0    # i3/i10/i20 tie at the top for u0
    V[7] = V[12]
    Uf = rng.normal(size=(N_USERS, 4)).astype(np.float32)
    Uf[0] = 1.0
    model = ALSModel(
        user_factors=Uf, item_factors=V,
        users=StringIndex([f"u{k}" for k in range(N_USERS)]),
        items=StringIndex([f"i{k}" for k in range(N_ITEMS)]),
        item_props={}, device="cpu",
    )
    algo, _ = _train("fused")
    jalgo, jmodel = _jax_side(model)
    for user in ("u0", "u1", "u2"):
        q = dict(user=user, num=N_ITEMS)
        got = algo.predict(model, Query(**q))
        _same(got, jalgo.predict(jmodel, JaxQuery(**q)))
    top = [s.item for s in algo.predict(model, Query("u0", 3)).item_scores]
    assert top == ["i3", "i10", "i20"]
    # a tie across the k-th place keeps the lower indices
    top = [s.item for s in algo.predict(model, Query("u0", 2)).item_scores]
    assert top == ["i3", "i10"]
    got = algo.batch_predict(model, [Query("u0", 2), Query("u1", 2)])
    assert [s.item for s in got[0].item_scores] == ["i3", "i10"]


def test_model_from_jax_serves_the_same():
    _, model = _train("pallas")
    jalgo, jmodel = _jax_side(model)
    port = model_from_jax(jmodel, device="cpu")
    algo, _ = _train("pallas")
    for q in QUERIES:
        _same(algo.predict(port, Query(**q)),
              jalgo.predict(jmodel, JaxQuery(**q)))


def test_params_validation():
    engine = recommendation_engine()
    with pytest.raises(ParamsError, match="unknown key"):
        engine.params_from_variant(
            {"algorithms": [{"name": "als", "params": {"rnk": 4}}]})
    # distributedTopk is accepted (with its candidate stage), as the
    # reference accepts it
    ep = engine.params_from_variant({"algorithms": [{
        "name": "als", "params": {"distributedTopk": True,
                                  "retrieval": "int8"}}]})
    assert ep.algorithms[0][1].distributed_topk is True
    assert ep.algorithms[0][1].retrieval == "int8"
    # coo='local' needs sharded placement on every algorithm, as the
    # reference checks at config time
    with pytest.raises(ValueError, match="requires factorPlacement"):
        engine.params_from_variant({
            "datasource": {"params": {"appName": "shop", "coo": "local"}},
            "algorithms": [{"name": "als", "params": {}}]})
    # sharded placement trains: one process on the CPU is a mesh of one
    # shard, which the reference trains replicated
    algo_ep = engine.params_from_variant({
        "datasource": {"params": {"appName": "shop", "coo": "local"}},
        "algorithms": [{
            "name": "als", "params": {"factorPlacement": "sharded",
                                      "codedShards": True}}]})
    ctx = WorkflowContext(device="cpu", storage=_store())
    (model,) = engine.train(ctx, algo_ep)
    assert ctx.mesh.size == 1
    rep_ep = engine.params_from_variant({
        "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "als", "params": {}}]})
    (want,) = engine.train(WorkflowContext(device="cpu", storage=_store()),
                           rep_ep)
    assert model.user_factors.tobytes() == want.user_factors.tobytes()


def test_data_source_needs_a_known_app():
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"datasource": {"params": {"appName": "nowhere"}}})
    ctx = WorkflowContext(device="cpu", storage=_memory_storage())
    with pytest.raises(ValueError, match="app 'nowhere' not found"):
        engine.train(ctx, ep)
