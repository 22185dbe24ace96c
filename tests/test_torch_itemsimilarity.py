"""The port's itemsimilarity engine against the JAX package's, on the view
store of ``test_torch_similarproduct`` (the engines share the data
source and the ``Query``).

* From the JAX trainer's initial factors the port's row-normalized item
  table is within 1e-4 of the JAX engine's (rank 4, λ 0.1).
* Replies name the same items in the same order as the JAX template
  serving the same table, scores within 1e-5 of their scale, for the
  exact scan, the int8 and the IVF two-stage retrievers (the port's
  builds are the reference's bit for bit), filtered and multi-item
  queries included; the query items never come back.
* The parameter checks, ``read_eval`` and a JAX model served through the
  port (``convert.itemsimilarity_model_from_jax``) are the reference's.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import ParamsError as JaxParamsError
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates import itemsimilarity as jis
from predictionio_tpu.templates import similarproduct as jsim
from predictionio_tpu_torch.controller import ParamsError, WorkflowContext
from predictionio_tpu_torch.convert import itemsimilarity_model_from_jax
from predictionio_tpu_torch.storage import Storage
from predictionio_tpu_torch.templates import itemsimilarity as its
from predictionio_tpu_torch.templates import similarproduct as sim
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("itemsimhome")
    make_home(path, view_events(seed=13))
    return path


@pytest.fixture()
def stores(home):
    st = {"torch": Storage({"PIO_TPU_HOME": str(home)}),
          "jax": JaxStorage({"PIO_TPU_HOME": str(home)})}
    yield st
    for s in st.values():
        s.close()


def variant(solver="xla", retrieval="exact", ds=None, **algo):
    return {"datasource": {"params": {"appName": "shop", **(ds or {})}},
            "algorithms": [{"name": "cosine", "params": {
                "rank": RANK, "numIterations": 3, "lambda": 0.1,
                "alpha": 2.0, "seed": 1, "solver": solver,
                "retrieval": retrieval, **algo}}]}


def trained(mod, ctx, v):
    engine = mod.itemsimilarity_engine()
    algos, models = engine.train_components(ctx, engine.params_from_variant(v))
    return algos[0], models[0]


QUERIES = [
    dict(items=("i0",), num=5),
    dict(items=("i1", "i3"), num=8),
    dict(items=("i2",), num=30),
    dict(items=("i2",), num=4, categories=("even",)),
    dict(items=("i4",), num=6, whitelist=("i1", "i2", "i3", "i9", "i10")),
    dict(items=("i5", "nope"), num=7, blacklist=("i0", "i7")),
    dict(items=("nope",), num=3),
    dict(items=("i6",), num=0),
]


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_normalized_table_matches_jax_from_the_same_start(
        stores, monkeypatch, solver):
    with_jax_init(monkeypatch, its)
    ctx, jctx = contexts(stores)
    _, port = trained(its, ctx, variant(solver))
    _, ref = trained(jis, jctx, variant(solver))
    got, want = port.item_factors, np.asarray(ref.item_factors)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert list(port.items.ids) == list(ref.items.ids)


def _jax_serving(model, retrieval, **params):
    algo = jis.ItemSimilarityAlgorithm()
    algo.params = jis.ItemSimilarityParams(retrieval=retrieval, **params)
    jm = jis.ItemSimilarityModel(
        item_factors=model.item_factors,
        items=JaxStringIndex(list(model.items.ids)),
        item_props=model.item_props,
    )
    return algo, jm


@pytest.mark.parametrize("retrieval", ["exact", "int8", "ivf"])
def test_replies_equal_the_jax_template_on_the_same_table(stores,
                                                          retrieval):
    ctx, _ = contexts(stores)
    params = dict(candidate_factor=2, nprobe=2, ann_clusters=4)
    algo, model = trained(its, ctx, variant(retrieval=retrieval))
    algo.params = its.ItemSimilarityParams(retrieval=retrieval, **params)
    algo.warmup(model, max_batch=8)
    jalgo, jm = _jax_serving(model, retrieval, **params)
    pq = [sim.Query(**q) for q in QUERIES]
    jq = [jsim.Query(**q) for q in QUERIES]
    solo = [algo.predict(model, q) for q in pq]
    for q, a, b in zip(pq, solo, (jalgo.predict(jm, q) for q in jq)):
        same_replies(a, b, q)
        assert {s.item for s in a.item_scores}.isdisjoint(q.items)
    for part in (slice(0, 3), slice(0, len(pq))):
        # an unfiltered batch takes the two-stage search, a filtered one
        # the exact masked scan
        for a, b in zip(algo.batch_predict(model, pq[part]),
                        jalgo.batch_predict(jm, jq[part])):
            same_replies(a, b)
    assert solo[0].item_scores


def test_params_checks_are_the_references():
    for bad in ({"retrieval": "hnsw"}, {"candidateFactor": 0},
                {"nprobe": 0}, {"annClusters": -1}):
        v = variant(**bad)
        with pytest.raises(ParamsError) as port:
            its.itemsimilarity_engine().params_from_variant(v)
        with pytest.raises(JaxParamsError) as ref:
            jis.itemsimilarity_engine().params_from_variant(v)
        assert str(port.value) == str(ref.value)


def test_read_eval_folds_equal_the_references(stores):
    ctx, jctx = contexts(stores)
    v = variant(ds={"evalHoldout": 0.4, "evalNum": 4})
    p, j = its.itemsimilarity_engine(), jis.itemsimilarity_engine()
    ((ptd, pei, pqa),) = p._data_source(p.params_from_variant(v)) \
        .read_eval(ctx)
    ((rtd, rei, rqa),) = j._data_source(j.params_from_variant(v)) \
        .read_eval(jctx)
    assert pei == rei
    same_ratings(ptd.ratings, rtd.ratings)
    assert [(q.items, q.num, a.items) for q, a in pqa] == [
        (q.items, q.num, a.items) for q, a in rqa]


def test_jax_model_served_through_the_port_and_persisted(stores):
    ctx, jctx = contexts(stores)
    jalgo, jm = trained(jis, jctx, variant(retrieval="int8"))
    model = itemsimilarity_model_from_jax(jm, "cpu")
    assert model.items is not jm.items
    algo = its.ItemSimilarityAlgorithm()
    algo.params = its.ItemSimilarityParams(retrieval="int8")
    pq = [sim.Query(**q) for q in QUERIES]
    jq = [jsim.Query(**q) for q in QUERIES]
    for a, b in zip(algo.batch_predict(model, pq),
                    jalgo.batch_predict(jm, jq)):
        same_replies(a, b)
    # the model persists through run_train and loads for deploy
    engine = its.itemsimilarity_engine()
    ep = engine.params_from_variant(variant())
    st = stores["torch"]
    iid = run_train(engine, ep, ctx=WorkflowContext(device="cpu",
                                                    storage=st))
    (loaded,) = prepare_deploy(engine, ep, iid, ctx=WorkflowContext(
        device="cpu", storage=st, mode="Serving"))
    _, fresh = trained(its, ctx, variant())
    assert loaded.item_factors.tobytes() == fresh.item_factors.tobytes()
    assert loaded.device == torch.device("cpu")
