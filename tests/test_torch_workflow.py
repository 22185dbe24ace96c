"""The port's train and deploy entry points on the CPU.

``run_train`` reads rate events from a SQLite store under a scratch
``$PIO_TPU_HOME``, trains the recommendation engine, writes the model
file and its manifest, and moves the engine instance through ``INIT →
TRAINING → COMPLETED`` (or ``FAILED``).  ``prepare_deploy`` then loads
the model, and a second load from a freshly opened storage (a new
process) serves the same answers.  The JAX package reads the instance
rows and the model keys the port writes.
"""

import json

import numpy as np
import pytest

from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.workflow.model_io import model_key as jax_model_key
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import (
    WorkflowParams,
    load_models,
    prepare_deploy,
    run_train,
    save_models,
)
from predictionio_tpu_torch.workflow.model_io import NotPersisted, model_key

VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1,
        "solver": "fused"}}],
}

QUERIES = [
    {"user": "u0", "num": 5},
    {"user": "u3", "num": 4, "categories": ["even"]},
    {"user": "u5", "num": 3, "whiteList": ["i1", "i2", "i3", "i9"]},
    {"user": "u7", "num": 6, "blackList": ["i0", "i4"]},
    {"user": "nobody", "num": 3},
]


def _home_with_events(home, n_users=30, n_items=20, seed=0) -> Storage:
    rng = np.random.default_rng(seed)
    st = Storage({"PIO_TPU_HOME": str(home)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    mask = rng.random((n_users, n_items)) < 0.4
    u, i = np.nonzero(mask)
    events = [
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(rng.integers(1, 11) * 0.5)})
        for a, b in zip(u.tolist(), i.tolist())
    ] + [
        Event(event="$set", entity_type="item", entity_id=f"i{j}",
              properties={"categories": ["even" if j % 2 == 0 else "odd"]})
        for j in range(n_items)
    ]
    with es.bulk():
        es.insert_batch(events, app.id)
    return st


class _StatusLog:
    """Records every status the metadata store writes for an instance,
    in order (``engine_instance_update`` writes through
    ``engine_instance_insert``)."""

    def __init__(self, md, monkeypatch):
        self.seen = []
        real = md.engine_instance_insert

        def record(ei):
            self.seen.append(ei.status)
            return real(ei)

        monkeypatch.setattr(md, "engine_instance_insert", record)


def _answers(engine, ep, iid, storage):
    ctx = WorkflowContext(device="cpu", storage=storage, mode="Serving")
    models = prepare_deploy(engine, ep, iid, ctx)
    algo = engine._algorithms(ep)[0]
    model = models[0]
    return model, [algo.predict(model, Query.from_json(q)).to_json()
                   for q in QUERIES]


def test_run_train_then_prepare_deploy_round_trips(tmp_path, monkeypatch):
    st = _home_with_events(tmp_path / "home")
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    log = _StatusLog(st.get_metadata(), monkeypatch)
    iid = run_train(engine, ep, ctx=WorkflowContext(device="cpu", storage=st))
    assert log.seen == ["INIT", "TRAINING", "COMPLETED"]
    rec = st.get_metadata().engine_instance_get(iid)
    assert rec.status == "COMPLETED" and rec.start_time and rec.end_time
    key = model_key(iid, 0, "als")
    manifest = json.loads(st.get_metadata().model_get(key).models.decode())
    assert manifest == {"kind": "pickle", "file": "model_0_als.pkl"}
    assert (st.model_data_dir() / iid / "model_0_als.pkl").is_file()

    model, before = _answers(engine, ep, iid, st)
    assert any(a["itemScores"] for a in before)
    st.close()
    # a new process: the storage opened afresh from the same home
    again = Storage({"PIO_TPU_HOME": str(tmp_path / "home")})
    model2, after = _answers(engine, ep, iid, again)
    assert after == before
    assert model2.user_factors.tobytes() == model.user_factors.tobytes()
    assert model2.item_factors.tobytes() == model.item_factors.tobytes()
    assert list(model2.items.ids) == list(model.items.ids)
    assert str(model2.device) == "cpu"


def test_failed_training_marks_the_instance_failed(tmp_path, monkeypatch):
    st = Storage({"PIO_TPU_HOME": str(tmp_path / "home")})
    st.get_metadata().app_insert("shop")          # an app with no events
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    log = _StatusLog(st.get_metadata(), monkeypatch)
    with pytest.raises(ValueError, match="no rating events"):
        run_train(engine, ep, ctx=WorkflowContext(device="cpu", storage=st))
    assert log.seen == ["INIT", "TRAINING", "FAILED"]
    (rec,) = st.get_metadata().engine_instance_get_all()
    assert rec.status == "FAILED" and rec.end_time


def test_unsaved_model_is_retrained_at_deploy(tmp_path):
    st = _home_with_events(tmp_path / "home")
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    ctx = WorkflowContext(device="cpu", storage=st)
    iid = run_train(engine, ep, ctx=ctx,
                    workflow_params=WorkflowParams(save_model=False))
    assert st.get_metadata().model_get(model_key(iid, 0, "als")) is None
    assert isinstance(load_models(ctx, iid, [("als", ALSAlgorithm)])[0],
                      NotPersisted)
    (model,) = prepare_deploy(engine, ep, iid, ctx)
    assert model.user_factors.shape[1] == 4

    class Transient(ALSAlgorithm):
        persist_model = False

    save_models(ctx, "x1", [("als", Transient(), model)])
    rec = st.get_metadata().model_get(model_key("x1", 0, "als"))
    assert json.loads(rec.models.decode()) == {"kind": "not_persisted"}
    st.get_metadata().model_insert(type(rec)(
        id=model_key("x2", 0, "als"),
        models=json.dumps({"kind": "sharded"}).encode()))
    with pytest.raises(NotImplementedError, match="sharded"):
        load_models(ctx, "x2", [("als", ALSAlgorithm)])


def test_jax_package_reads_the_ports_instance_rows(tmp_path):
    st = _home_with_events(tmp_path / "home")
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    iid = run_train(engine, ep, ctx=WorkflowContext(device="cpu", storage=st))
    jax = JaxStorage({"PIO_TPU_HOME": str(tmp_path / "home")})
    jrec = jax.get_metadata().engine_instance_get(iid)
    assert jrec.status == "COMPLETED"
    assert jax.get_metadata().engine_instance_get_latest_completed(
        "default", "1", "engine.json").id == iid
    jep = jax_recommendation_engine().params_from_instance(jrec)
    assert jep.algorithms[0][0] == "als"
    assert jep.algorithms[0][1].rank == 4
    assert jep.data_source[1].app_name == "shop"
    assert model_key(iid, 0, "als") == jax_model_key(iid, 0, "als")
    assert jax.get_metadata().model_get(model_key(iid, 0, "als")) is not None
