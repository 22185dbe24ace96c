"""The port's similarproduct engine against the JAX package's, on one
small SQLite store both packages read (30 users' view events over 24
items, some pairs viewed twice or three times, and a category ``$set``
per item, made from a numpy seed).

* The implicit read (``find_ratings(..., rating_property=None,
  dedup="sum")`` on SQLite, ``find_columnar -> to_ratings`` in memory)
  gives the reference's ``Ratings`` bit for bit.
* From the JAX trainer's initial factors (carried across with
  ``convert.factors_from_jax``) the port's row-normalized item table is
  within 1e-4 of the JAX engine's (the same f32 arithmetic in another
  order; rank 4, λ 0.1).
* Replies name the same items in the same order as the JAX template
  serving the same table, with scores within 1e-5 of their scale (both
  compute f32 products, in another order): the port's table served by
  the JAX template, and the JAX model served by the port
  (``convert.similar_model_from_jax``).
* ``read_eval``'s hold-out split and the ``.npz`` format equal the
  reference's.
"""

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import WorkflowContext as JaxContext
from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates import _common as jcommon
from predictionio_tpu.templates import similarproduct as jsim
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import (
    factors_from_jax,
    similar_model_from_jax,
)
from predictionio_tpu_torch.storage import Event, Storage, StringIndex
from predictionio_tpu_torch.templates import _common
from predictionio_tpu_torch.templates import similarproduct as sim

N_USERS, N_ITEMS = 30, 24
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def view_events(seed: int = 5, name: str = "view") -> list[dict]:
    """Each user views 6-10 items of a cluster-biased catalog; a third of
    the views repeat once or twice (implicit counts 1-3)."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(N_USERS):
        pool = np.arange(u % 2, N_ITEMS, 2) if u % 3 else np.arange(N_ITEMS)
        for i in rng.choice(pool, size=int(rng.integers(6, 11)),
                            replace=False).tolist():
            rows += [dict(event=name, entity_type="user",
                          entity_id=f"u{u}", target_entity_type="item",
                          target_entity_id=f"i{i}")] * int(
                rng.choice([1, 1, 2, 3]))
    rows += [dict(event="$set", entity_type="item", entity_id=f"i{j}",
                  properties={"categories": ["even" if j % 2 == 0
                                             else "odd"]})
             for j in range(N_ITEMS)]
    return rows


def make_home(path, rows) -> None:
    st = Storage({"PIO_TPU_HOME": str(path)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    es.insert_batch([Event(**r) for r in rows], app.id)
    st.close()


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("simhome")
    make_home(path, view_events())
    return path


@pytest.fixture()
def stores(home):
    st = {"torch": Storage({"PIO_TPU_HOME": str(home)}),
          "jax": JaxStorage({"PIO_TPU_HOME": str(home)})}
    yield st
    for s in st.values():
        s.close()


def memory_stores(rows):
    """The same events in each package's in-memory store (its columnar
    read, no native scan)."""
    conf = {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory"}
    out = {}
    for kind, cls, ev in (("torch", Storage, Event),
                          ("jax", JaxStorage, JaxEvent)):
        st = cls(dict(conf))
        app = st.get_metadata().app_insert("shop")
        st.get_event_store().init_channel(app.id)
        st.get_event_store().insert_batch([ev(**r) for r in rows], app.id)
        out[kind] = st
    return out


def contexts(stores):
    return (WorkflowContext(device="cpu", storage=stores["torch"]),
            JaxContext(storage=stores["jax"]))


def same_ratings(a, b) -> None:
    for name in ("user_ix", "item_ix", "rating"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert list(a.users.ids) == list(b.users.ids)
    assert list(a.items.ids) == list(b.items.ids)


def with_jax_init(monkeypatch, module):
    """Start the port's trainer in ``module`` from the JAX trainer's
    initial factors for the same ratings and config."""
    real = module.train_als

    def train(ratings, cfg, device):
        ref = JaxALSTrainer(
            (ratings.user_ix, ratings.item_ix, ratings.rating),
            len(ratings.users), len(ratings.items),
            JaxALSConfig(rank=cfg.rank, seed=cfg.seed, implicit=True,
                         alpha=cfg.alpha, lam=cfg.lam))
        U0, V0 = (np.asarray(a) for a in ref.init_factors())
        return real(ratings, cfg=cfg, device=device,
                    init=factors_from_jax(U0, V0, device))

    monkeypatch.setattr(module, "train_als", train)


def same_replies(got, want, what="") -> None:
    """The same items in the same order, scores within 1e-5 of their
    scale."""
    g, w = got.to_json()["itemScores"], want.to_json()["itemScores"]
    assert [s["item"] for s in g] == [s["item"] for s in w], what
    scale = max([abs(s["score"]) for s in w] + [1.0])
    for a, b in zip(g, w):
        assert abs(a["score"] - b["score"]) <= 1e-5 * scale, (what, a, b)


def variant(solver="xla", **extra):
    return {"datasource": {"params": {"appName": "shop", **extra}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": 3, "lambda": 0.1,
                "alpha": 2.0, "seed": 1, "solver": solver}}]}


def trained(mod, ctx, v):
    engine = mod.similarproduct_engine()
    algos, models = engine.train_components(ctx, engine.params_from_variant(v))
    return algos[0], models[0]


QUERIES = [
    dict(items=("i0",), num=5),
    dict(items=("i1", "i3"), num=30),
    dict(items=("i2",), num=4, categories=("even",)),
    dict(items=("i4",), num=6, whitelist=("i1", "i2", "i3", "i9", "i10")),
    dict(items=("i5", "nope"), num=7, blacklist=("i0", "i7")),
    dict(items=("nope",), num=3),
    dict(items=("i6",), num=0),
]


@pytest.mark.parametrize("where", ["sqlite", "memory"])
def test_implicit_read_gives_the_references_ratings(stores, where):
    st = stores if where == "sqlite" else memory_stores(view_events())
    ctx, jctx = contexts(st)
    p, j = sim.similarproduct_engine(), jsim.similarproduct_engine()
    port = p._data_source(p.params_from_variant(variant())) \
        .read_training(ctx)
    ref = j._data_source(j.params_from_variant(variant())) \
        .read_training(jctx)
    same_ratings(port.ratings, ref.ratings)
    assert port.items == ref.items
    # counts, not ones: a third of the pairs were viewed again
    assert port.ratings.rating.max() == 3.0
    if where == "sqlite":
        assert st["torch"].get_event_store().last_ratings_scan_path == \
            "native"


@pytest.mark.parametrize("solver", ["xla", "pallas", "fused"])
def test_normalized_table_matches_jax_from_the_same_start(
        stores, monkeypatch, solver):
    with_jax_init(monkeypatch, sim)
    ctx, jctx = contexts(stores)
    _, port = trained(sim, ctx, variant(solver))
    _, ref = trained(jsim, jctx, variant(solver))
    got, want = port.item_factors, np.asarray(ref.item_factors)
    assert got.shape == want.shape == (N_ITEMS, RANK)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert list(port.items.ids) == list(ref.items.ids)
    assert port.item_props == ref.item_props


def _jax_serving(model):
    """The JAX template's algorithm and model on the port's table."""
    algo = jsim.SimilarProductAlgorithm()
    algo.params = jsim.SimilarALSParams()
    jm = jsim.SimilarALSModel(
        item_factors=model.item_factors,
        items=JaxStringIndex(list(model.items.ids)),
        item_props=model.item_props,
    )
    return algo, jm


def test_replies_equal_the_jax_template_on_the_same_table(stores):
    ctx, jctx = contexts(stores)
    algo, model = trained(sim, ctx, variant())
    algo.warmup(model, max_batch=8)
    jalgo, jm = _jax_serving(model)
    pq = [sim.Query(**q) for q in QUERIES]
    jq = [jsim.Query(**q) for q in QUERIES]
    for a, b in zip(pq, jq):
        same_replies(algo.predict(model, a), jalgo.predict(jm, b), a)
    for a, b in zip(algo.batch_predict(model, pq),
                    jalgo.batch_predict(jm, jq)):
        same_replies(a, b)
    # the query items and the black list never come back
    (r,) = algo.batch_predict(model, [pq[4]])
    assert {s.item for s in r.item_scores}.isdisjoint({"i5", "i0", "i7"})


def test_jax_model_served_through_the_port(stores):
    ctx, jctx = contexts(stores)
    jalgo, jm = trained(jsim, jctx, variant())
    model = similar_model_from_jax(jm, "cpu")
    assert model.items is not jm.items
    algo = sim.SimilarProductAlgorithm()
    algo.params = sim.SimilarALSParams()
    pq = [sim.Query(**q) for q in QUERIES]
    jq = [jsim.Query(**q) for q in QUERIES]
    for a, b in zip(algo.batch_predict(model, pq),
                    jalgo.batch_predict(jm, jq)):
        same_replies(a, b)


def test_a_zero_row_stays_zero_and_scores_zero():
    """An item nobody viewed in training has a zero factor row: it stays
    zero through the normalization (the 1e-9 in the norm) and scores 0,
    as in the reference."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(6, RANK)).astype(np.float32)
    table[3] = 0.0
    got = _common.normalize_rows(table)
    want = np.asarray(jcommon.normalize_rows(table))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert not got[3].any()
    model = sim.SimilarALSModel(
        item_factors=got, items=StringIndex([f"i{j}" for j in range(6)]),
        item_props={}, device=torch.device("cpu"))
    algo = sim.SimilarProductAlgorithm()
    algo.params = sim.SimilarALSParams()
    r = algo.predict(model, sim.Query(items=("i0",), num=5))
    scores = {s.item: s.score for s in r.item_scores}
    assert scores["i3"] == 0.0
    jalgo, jm = _jax_serving(model)
    same_replies(r, jalgo.predict(jm, jsim.Query(items=("i0",), num=5)))


def test_read_eval_folds_equal_the_references(stores):
    ctx, jctx = contexts(stores)
    v = variant(evalHoldout=0.3, evalNum=5, evalSeed=11)
    p = sim.similarproduct_engine()
    j = jsim.similarproduct_engine()
    port = p._data_source(p.params_from_variant(v)).read_eval(ctx)
    ref = j._data_source(j.params_from_variant(v)).read_eval(jctx)
    assert len(port) == len(ref) == 1
    (ptd, pei, pqa), (rtd, rei, rqa) = port[0], ref[0]
    assert pei == rei
    same_ratings(ptd.ratings, rtd.ratings)
    assert ptd.items == rtd.items
    assert [(q.items, q.num, a.items) for q, a in pqa] == [
        (q.items, q.num, a.items) for q, a in rqa]
    assert len(pqa) > 10


def test_npz_round_trips_and_reads_the_references_files(stores, tmp_path):
    ctx, jctx = contexts(stores)
    algo, model = trained(sim, ctx, variant())
    manifest = algo.save_model(ctx, "m1", model, tmp_path / "port")
    back = algo.load_model(ctx, "m1", manifest, tmp_path / "port")
    assert back.item_factors.tobytes() == model.item_factors.tobytes()
    assert list(back.items.ids) == list(model.items.ids)
    assert back.item_props == model.item_props
    # the reference reads the port's file, the port the reference's
    jalgo, jm = trained(jsim, jctx, variant())
    jback = jalgo.load_model(jctx, "m1", manifest, tmp_path / "port")
    assert np.asarray(jback.item_factors).tobytes() == \
        model.item_factors.tobytes()
    jman = jalgo.save_model(jctx, "m2", jm, tmp_path / "jax")
    pback = algo.load_model(ctx, "m2", jman, tmp_path / "jax")
    assert pback.item_factors.tobytes() == \
        np.asarray(jm.item_factors).tobytes()
    assert list(pback.items.ids) == list(jm.items.ids)
    # a file without the normalized marker (raw factors) is normalized
    # once at load, as the reference does
    raw = np.asarray(jm.item_factors) * 3.0
    np.savez_compressed(tmp_path / "raw.npz", item_factors=raw,
                        item_ids=jm.items.ids.astype(str))
    (tmp_path / "raw-props.json").write_text(json.dumps(jm.item_props))
    legacy = {"npz": "raw.npz", "props": "raw-props.json"}
    got = algo.load_model(ctx, "m3", legacy, tmp_path).item_factors
    want = np.asarray(jalgo.load_model(jctx, "m3", legacy,
                                       tmp_path).item_factors)
    assert got.tobytes() == want.tobytes()


def test_registered_engines_train_by_name_and_serve_as_tenants(tmp_path):
    """``train --engine NAME`` of two registered engines, then one server
    whose tenants.json names them (``"engine": NAME``): each tenant
    answers as its engine's in-process ``predict``."""
    import argparse
    import urllib.request

    from predictionio_tpu_torch import engines
    from predictionio_tpu_torch.cli.main import _build_tenant_registry, main
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    try:
        app = st.get_metadata().app_insert("MyApp")
        st.get_event_store().init_channel(app.id)
        st.get_event_store().insert_batch(
            [Event(**r) for r in view_events()], app.id)
        names = {"sim": "similarproduct", "cos": "itemsimilarity"}
        for name in names.values():
            assert main(["train", "--engine", name], storage=st,
                        device="cpu") == 0
        tj = tmp_path / "tenants.json"
        tj.write_text(json.dumps({"tenants": [
            {"app": "MyApp", "variant": v, "engine": n}
            for v, n in names.items()]}))
        reg = _build_tenant_registry(argparse.Namespace(
            multi=str(tj), memory_budget=None, autopilot=None), st)
        serving = WorkflowContext(device="cpu", storage=st, mode="Serving")
        want = {}
        for v, name in names.items():
            engine, ep, _ = engines.resolve(name)
            iid = st.get_metadata().engine_instance_get_latest_completed(
                name, "1", engines.get_engine_spec(
                    name).instance_variant_key()).id
            algos, models, _ = prepare_deploy_components(engine, ep, iid,
                                                         ctx=serving)
            want[v] = algos[0].predict(
                models[0], sim.Query(items=("i0",), num=4)).to_json()
            if v == "sim":
                anchor = (engine, ep, iid)
        srv = EngineServer(*anchor, ctx=serving, config=ServerConfig(
            port=0, microbatch="off"), engine_id="similarproduct",
            engine_variant="engine:similarproduct", tenants=reg)
        srv.start_background()
        try:
            for v in names:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/queries.json",
                    data=json.dumps({"items": ["i0"], "num": 4,
                                     "app": "MyApp", "variant": v}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    got = json.loads(r.read())
                assert got["variant"] == v
                assert [s["item"] for s in got["itemScores"]] == [
                    s["item"] for s in want[v]["itemScores"]]
                assert "i0" not in [s["item"] for s in got["itemScores"]]
        finally:
            srv.stop()
    finally:
        st.close()
