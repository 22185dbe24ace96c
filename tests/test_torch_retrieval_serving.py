"""The recommendation template's two-stage retrieval (``retrieval`` int8
and ivf) against the JAX template's, on the CPU.

Both templates serve the same factors (``convert.model_from_jax``):
``predict`` and ``batch_predict`` must name the same items in the same
order with scores within 1e-5 of their scale (the rerank scores are the
exact scan's, in f32); filtered queries stay on the exact scan in both.
Ties: both rank with ``lax.top_k``'s order, and the random factors here
give no score ties.  A fold-in delta applied by each package's
``apply_model_delta`` patches each cached retriever in place and leaves
the two answering alike; the reference ANN smoke's invariants
(``chip_smoke.scout_invariants``, which phase scout runs at ML-20M width
on the card) hold on a small catalog.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from predictionio_tpu.live.apply import (
    apply_model_delta as jax_apply_model_delta,
)
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSModel as JaxALSModel,
    Query as JaxQuery,
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.workflow.model_io import ModelDelta as JaxModelDelta
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.live.apply import apply_model_delta
from predictionio_tpu_torch.ops.topk import topk_scores
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.model_io import ModelDelta

N_USERS, N_ITEMS, RANK = 30, 400, 16


def _jax_model(seed=0):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(N_ITEMS, RANK)) * rng.uniform(0.2, 2.0,
                                                           (N_ITEMS, 1))
    return JaxALSModel(
        user_factors=rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        item_factors=items.astype(np.float32),
        users=JaxStringIndex([f"u{k}" for k in range(N_USERS)]),
        items=JaxStringIndex([f"i{k}" for k in range(N_ITEMS)]),
        item_props={f"i{k}": {"categories": ["even" if k % 2 else "odd"]}
                    for k in range(N_ITEMS)},
    )


def _algos(mode: str, **params):
    kw = dict(retrieval=mode, ann_clusters=16, **params)
    port, ref = ALSAlgorithm(), JaxALSAlgorithm()
    port.params = port.params_class(**kw)
    ref.params = ref.params_class(**kw)
    return port, ref


def _same(got, want) -> None:
    g = [(s.item, s.score) for s in got.item_scores]
    w = [(s.item, s.score) for s in want.item_scores]
    assert [i for i, _ in g] == [i for i, _ in w]
    scale = max([abs(s) for _, s in w] + [1.0])
    for (_, a), (_, b) in zip(g, w):
        assert abs(a - b) <= 1e-5 * scale


QUERIES = ([dict(user=f"u{k}", num=n) for k, n in
            ((0, 10), (1, 4), (2, 1), (3, 25), (5, 10))]
           + [dict(user="u4", num=6, categories=("even",)),
              dict(user="u6", num=5, blacklist=("i1", "i2")),
              dict(user="nobody", num=5), dict(user="u7", num=0)])


@pytest.mark.parametrize("mode", ["int8", "ivf"])
def test_predict_and_batch_predict_match_the_references(mode):
    jmodel = _jax_model()
    port_model = model_from_jax(jmodel, "cpu")
    port, ref = _algos(mode, candidate_factor=3, nprobe=4)
    port.warmup(port_model, max_batch=8)
    ref.warmup(jmodel, max_batch=8)
    for q in QUERIES:
        _same(port.predict(port_model, Query(**q)),
              ref.predict(jmodel, JaxQuery(**q)))
    got = port.batch_predict(port_model, [Query(**q) for q in QUERIES])
    want = ref.batch_predict(jmodel, [JaxQuery(**q) for q in QUERIES])
    for g, w in zip(got, want):
        _same(g, w)
    assert (port_model.device_ann_index(port._retrieval_config()).summary()
            == jmodel.device_ann_index(ref._retrieval_config()).summary())


def test_engine_json_keys_and_validation_match_the_references():
    variant = {"algorithms": [{"name": "als", "params": {
        "rank": 4, "retrieval": "ivf", "candidateFactor": 5, "nprobe": 3,
        "annClusters": 32, "solverMode": "subspace", "subspaceSize": 2,
        "gatherMode": "grouped", "solver": "pallas"}}]}
    ((_, port),) = recommendation_engine().params_from_variant(
        variant).algorithms
    ((_, ref),) = jax_recommendation_engine().params_from_variant(
        variant).algorithms
    for k in ("retrieval", "candidate_factor", "nprobe", "ann_clusters",
              "solver_mode", "subspace_size", "gather_mode"):
        assert getattr(port, k) == getattr(ref, k), k
    algo = ALSAlgorithm()
    algo.params = port
    assert algo._config().solver_mode == "subspace"
    assert algo._retrieval_config().cache_key() == "ivf_cf5_np3_c32_s0"
    for bad in ({"retrieval": "annoy"}, {"candidateFactor": 0},
                {"nprobe": 0}, {"annClusters": -1}):
        v = {"algorithms": [{"name": "als", "params": bad}]}
        with pytest.raises(Exception) as port_err:
            recommendation_engine().params_from_variant(v)
        with pytest.raises(Exception) as ref_err:
            jax_recommendation_engine().params_from_variant(v)
        assert type(port_err.value).__name__ == type(ref_err.value).__name__


def test_a_delta_patches_both_packages_retrievers_alike():
    jmodel = _jax_model(seed=3)
    port_model = model_from_jax(jmodel, "cpu")
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(2, RANK)).astype(np.float32) * 3
    new_item = rng.normal(size=(1, RANK)).astype(np.float32) * 3
    new_user = rng.normal(size=(1, RANK)).astype(np.float32)
    fields = dict(
        seq=1, meta={"baseUsers": N_USERS, "baseItems": N_ITEMS},
        user_rows_ix=np.zeros(0, np.int32),
        user_rows=np.zeros((0, RANK), np.float32),
        new_user_ids=np.array(["u-new"]), new_user_rows=new_user,
        item_rows_ix=np.array([5, 77], np.int32), item_rows=rows,
        new_item_ids=np.array(["i-new"]), new_item_rows=new_item)
    pairs = [_algos(m, candidate_factor=4, nprobe=3) for m in
             ("int8", "ivf")]
    for port, ref in pairs:   # build (and cache) each retriever first
        port.predict(port_model, Query(user="u0", num=5))
        ref.predict(jmodel, JaxQuery(user="u0", num=5))
    got = apply_model_delta(port_model, ModelDelta(**fields))
    want = jax_apply_model_delta(jmodel, JaxModelDelta(**fields))
    assert got == want and got["annIndexesPatched"] == 2
    for port, ref in pairs:
        assert (port_model.device_ann_index(port._retrieval_config())
                .patches == 1)
        for q in [dict(user=f"u{k}", num=8) for k in range(6)] + [
                dict(user="u-new", num=8)]:
            _same(port.predict(port_model, Query(**q)),
                  ref.predict(jmodel, JaxQuery(**q)))


@pytest.mark.parametrize("mode", ["int8", "ivf"])
def test_a_search_on_a_table_taken_before_an_append_skips_the_new_item(
        mode):
    # a query holds the serving table it took before a fold-in delta
    # appended an item to the index: its search must not gather past
    # that table, and answers as the exact scan of the table it holds
    port_model = model_from_jax(_jax_model(seed=5), "cpu")
    port, _ = _algos(mode, candidate_factor=64, nprobe=64)
    port.predict(port_model, Query(user="u0", num=8))
    table = port_model.device_item_factors(port._serve_dtype())
    uvec = torch.as_tensor(port_model.user_factors[0])
    apply_model_delta(port_model, ModelDelta(
        seq=1, meta={"baseUsers": N_USERS, "baseItems": N_ITEMS},
        user_rows_ix=np.zeros(0, np.int32),
        user_rows=np.zeros((0, RANK), np.float32),
        new_user_ids=np.array([], dtype=str),
        new_user_rows=np.zeros((0, RANK), np.float32),
        item_rows_ix=np.zeros(0, np.int32),
        item_rows=np.zeros((0, RANK), np.float32),
        new_item_ids=np.array(["i-new"]),
        new_item_rows=(50 * uvec[None, :]).numpy()))
    index = port_model.device_ann_index(port._retrieval_config())
    assert index.n_items == N_ITEMS + 1
    vals, ixs = index.search(uvec[None, :], 8, table)
    want_vals, want_ixs = topk_scores(uvec, table, 8)
    assert ixs[0].tolist() == want_ixs.tolist()
    assert torch.allclose(vals[0], want_vals, rtol=1e-5, atol=1e-5)


def test_the_ann_smoke_invariants_hold():
    model = model_from_jax(_jax_model(seed=7), "cpu")
    checks, detail = chip_smoke.scout_invariants(
        model, [f"u{k}" for k in range(8)])
    assert all(checks.values()), (checks, detail)
    assert detail["stages"]["searches"] == 4
    # the delta appended its item to the model
    assert len(model.items) == model.item_factors.shape[0] == 401
