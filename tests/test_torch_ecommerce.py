"""The port's ecommerce engine against the JAX package's, on one small
SQLite store both packages read: the view events of
``test_torch_similarproduct``, a ``buy`` for some of them, a ``rate``
event with a half-star rating for every viewed pair, and a
``constraint``/``unavailableItems`` ``$set``.

* Both reads (implicit view counts; ``rate`` events through
  ``ratingProperty``) give the reference's ``Ratings`` bit for bit.
* From the JAX trainer's initial factors both factor tables are within
  1e-4 of the JAX engine's (rank 4, λ 0.1).
* With the predict-time event-store reads (``unseenOnly`` with
  ``seenEvents``, the unavailable constraint) and the query's filters,
  replies name the same items in the same order as the JAX template
  serving the same model, scores within 1e-5 of their scale, and hold
  no seen or unavailable item; a read that raises filters nothing, as
  in the reference.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates import ecommerce as jecom
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import ecomm_model_from_jax
from predictionio_tpu_torch.storage import Storage
from predictionio_tpu_torch.templates import ecommerce as ecom
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.workflow import prepare_deploy, run_train
from test_torch_similarproduct import (
    contexts,
    make_home,
    same_ratings,
    same_replies,
    view_events,
    with_jax_init,
)

RANK = 4
UNAVAILABLE = ["i2", "i5", "i11"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def shop_events() -> list[dict]:
    rows = view_events(seed=9)
    rng = np.random.default_rng(9)
    views = {(r["entity_id"], r["target_entity_id"]) for r in rows
             if r["event"] == "view"}
    for u, i in sorted(views):
        rows.append(dict(event="rate", entity_type="user", entity_id=u,
                         target_entity_type="item", target_entity_id=i,
                         properties={"rating":
                                     float(rng.integers(1, 11)) / 2}))
        if rng.random() < 0.3:
            rows.append(dict(event="buy", entity_type="user", entity_id=u,
                             target_entity_type="item", target_entity_id=i))
    rows.append(dict(event="$set", entity_type="constraint",
                     entity_id="unavailableItems",
                     properties={"items": UNAVAILABLE}))
    return rows


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("ecomhome")
    make_home(path, shop_events())
    return path


@pytest.fixture()
def stores(home):
    st = {"torch": Storage({"PIO_TPU_HOME": str(home)}),
          "jax": JaxStorage({"PIO_TPU_HOME": str(home)})}
    yield st
    for s in st.values():
        s.close()


def variant(solver="xla", rate=False, **algo):
    ds = {"appName": "shop"}
    if rate:
        ds.update(viewEvents=["rate"], ratingProperty="rating")
    return {"datasource": {"params": ds},
            "algorithms": [{"name": "ecomm", "params": {
                "rank": RANK, "numIterations": 3, "lambda": 0.1,
                "alpha": 1.0, "seed": 1, "solver": solver, **algo}}]}


def trained(mod, ctx, v):
    engine = mod.ecommerce_engine()
    algos, models = engine.train_components(ctx, engine.params_from_variant(v))
    return algos[0], models[0]


QUERIES = [
    dict(user="u0", num=5),
    dict(user="u1", num=30),
    dict(user="u2", num=4, categories=("even",)),
    dict(user="u3", num=6, whitelist=("i1", "i2", "i3", "i9", "i10")),
    dict(user="u4", num=7, blacklist=("i0", "i7")),
    dict(user="nobody", num=3),
    dict(user="u6", num=0),
]


@pytest.mark.parametrize("rate", [False, True])
def test_read_gives_the_references_ratings(stores, rate):
    ctx, jctx = contexts(stores)
    p, j = ecom.ecommerce_engine(), jecom.ecommerce_engine()
    port = p._data_source(p.params_from_variant(variant(rate=rate))) \
        .read_training(ctx)
    ref = j._data_source(j.params_from_variant(variant(rate=rate))) \
        .read_training(jctx)
    same_ratings(port.ratings, ref.ratings)
    assert port.items == ref.items and port.app_id == ref.app_id
    assert stores["torch"].get_event_store().last_ratings_scan_path == \
        "native"


@pytest.mark.parametrize("solver,rate", [("xla", False), ("fused", True)])
def test_factors_match_jax_from_the_same_start(stores, monkeypatch, solver,
                                               rate):
    with_jax_init(monkeypatch, ecom)
    ctx, jctx = contexts(stores)
    _, port = trained(ecom, ctx, variant(solver, rate))
    _, ref = trained(jecom, jctx, variant(solver, rate))
    for got, want in ((port.user_factors, ref.user_factors),
                      (port.item_factors, ref.item_factors)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert list(port.users.ids) == list(ref.users.ids)


def _jax_serving(model, jctx, **params):
    algo = jecom.ECommAlgorithm()
    algo.params = jecom.ECommAlgorithmParams(**params)
    algo._ctx = jctx
    jm = jecom.ECommModel(
        user_factors=model.user_factors, item_factors=model.item_factors,
        users=JaxStringIndex(list(model.users.ids)),
        items=JaxStringIndex(list(model.items.ids)),
        item_props=model.item_props, app_id=model.app_id,
    )
    return algo, jm


def _seen(es, app_id, user, events):
    return {e.target_entity_id for e in es.find(
        app_id=app_id, entity_type="user", entity_id=user,
        event_names=list(events))}


@pytest.mark.parametrize("unseen_only", [False, True])
def test_replies_equal_the_jax_template_with_the_store_filters(
        stores, unseen_only):
    ctx, jctx = contexts(stores)
    params = dict(unseen_only=unseen_only, seen_events=("view", "buy"))
    algo, model = trained(ecom, ctx, variant())
    algo.params = ecom.ECommAlgorithmParams(**params)
    algo.warmup(model, max_batch=8)
    jalgo, jm = _jax_serving(model, jctx, **params)
    pq = [rec.Query(**q) for q in QUERIES]
    jq = [jrec.Query(**q) for q in QUERIES]
    solo = [algo.predict(model, q) for q in pq]
    for a, b in zip(solo, (jalgo.predict(jm, q) for q in jq)):
        same_replies(a, b)
    batched = algo.batch_predict(model, pq)
    for a, b in zip(batched, jalgo.batch_predict(jm, jq)):
        same_replies(a, b)
    es = stores["torch"].get_event_store()
    for q, a, b in zip(pq, solo, batched):
        items = {s.item for s in a.item_scores} | {
            s.item for s in b.item_scores}
        assert items.isdisjoint(UNAVAILABLE)
        if unseen_only:
            assert items.isdisjoint(
                _seen(es, model.app_id, q.user, ("view", "buy")))
    assert any(r.item_scores for r in solo)


def test_a_failing_store_read_filters_nothing(stores, monkeypatch, caplog):
    """Both predict-time reads catch every exception, log it and return
    the empty set (`ecommerce.py:194-196`, `:209-211`)."""
    ctx, _ = contexts(stores)
    algo, model = trained(ecom, ctx, variant())
    algo.params = ecom.ECommAlgorithmParams(unseen_only=True)
    q = rec.Query(user="u1", num=40)
    es = stores["torch"].get_event_store()

    def broken(*a, **kw):
        raise RuntimeError("store down")

    monkeypatch.setattr(type(es), "find", broken)
    monkeypatch.setattr(type(es), "aggregate_properties_single_entity",
                        broken)
    got = algo.predict(model, q)
    algo.params = ecom.ECommAlgorithmParams(unseen_only=False)
    monkeypatch.setattr(algo, "_unavailable_items", lambda m: set())
    want = algo.predict(model, q)
    assert got == want
    assert len(got.item_scores) == len(model.items)
    assert "error reading seen events" in caplog.text
    assert "error reading unavailableItems" in caplog.text


def test_jax_model_served_through_the_port(stores):
    ctx, jctx = contexts(stores)
    params = dict(unseen_only=True, seen_events=("buy",))
    jalgo, jm = trained(jecom, jctx, variant(**{
        "unseenOnly": True, "seenEvents": ["buy"]}))
    model = ecomm_model_from_jax(jm, "cpu")
    assert model.users is not jm.users and model.app_id == jm.app_id
    algo = ecom.ECommAlgorithm()
    algo.params = ecom.ECommAlgorithmParams(**params)
    algo._ctx = ctx
    pq = [rec.Query(**q) for q in QUERIES]
    jq = [jrec.Query(**q) for q in QUERIES]
    for a, b in zip(algo.batch_predict(model, pq),
                    jalgo.batch_predict(jm, jq)):
        same_replies(a, b)


def test_a_trained_instance_deploys_with_its_store_reads(stores):
    """``run_train`` persists the model; ``prepare_deploy`` loads it on
    the serving context, whose store the predict-time reads use."""
    st = stores["torch"]
    engine = ecom.ecommerce_engine()
    ep = engine.params_from_variant(variant(**{"unseenOnly": True}))
    ctx = WorkflowContext(device="cpu", storage=st)
    iid = run_train(engine, ep, ctx=ctx)
    _, model = trained(ecom, ctx, variant())
    (loaded,) = prepare_deploy(
        engine, ep, iid,
        ctx=WorkflowContext(device="cpu", storage=st, mode="Serving"))
    assert loaded.item_factors.tobytes() == model.item_factors.tobytes()
    assert loaded.device == torch.device("cpu")
    algo = engine._algorithms(ep)[0]
    algo._ctx = WorkflowContext(device="cpu", storage=st, mode="Serving")
    r = algo.predict(loaded, rec.Query(user="u0", num=40))
    seen = _seen(st.get_event_store(), loaded.app_id, "u0", ("view", "buy"))
    assert {s.item for s in r.item_scores}.isdisjoint(seen | set(UNAVAILABLE))
    assert r.item_scores
