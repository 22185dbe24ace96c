"""The port's multi-process training on the CPU, through gloo processes.

Mirrors ``tests/test_multihost.py``: the entity-hash scan shards, the id
and owner exchanges (with the torn-exchange retry and degrade of
``tests/test_chaos_distributed.py``), ``ALSTrainer.distributed`` at two
and four processes against the reference's sharded trainer, and
``train --coordinator`` through the console, whose sharded ``.npz``
model deploys.  Every spawning test runs its processes
(``tests/torch_dist_worker.py``) under its own timeout and kills them on
expiry, so a hang fails the test and does not stall the suite.

Tolerances: the exchange orders each row's ratings by (row, col), the
single-process staging by scan order, so the sums run in another order:
factors agree within 1e-4 of their scale.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu.parallel.ingest import shard_mask as jax_shard_mask
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSModel as JaxALSModel,
)
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.workflow import model_io as jax_model_io
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
from predictionio_tpu_torch.obs import RESILIENCE_TOTAL, runlog
from predictionio_tpu_torch.parallel import ingest, make_mesh
from predictionio_tpu_torch.parallel.ingest import (
    ExchangeTornError,
    exchange_ratings_by_owner,
    find_columnar_sharded,
)
from predictionio_tpu_torch.resilience import RetryPolicy, faults
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSModel,
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import model_io, prepare_deploy

from torch_dist_worker import spawn

FACTORY = ("predictionio_tpu_torch.templates.recommendation."
           "recommendation_engine")


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


def _toy(n_users=37, n_items=23, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((n_users, n_items)) < 0.4
    u, i = np.nonzero(mask)
    v = rng.integers(1, 11, len(u)).astype(np.float32) * 0.5
    return u.astype(np.int32), i.astype(np.int32), v, n_users, n_items


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _home(home, n_users=24, n_items=16, seed=0) -> Storage:
    rng = np.random.default_rng(seed)
    st = Storage({"PIO_TPU_HOME": str(home)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    mask = rng.random((n_users, n_items)) < 0.5
    u, i = np.nonzero(mask)
    events = [
        Event(event="rate", entity_type="user", entity_id=f"u{a}",
              target_entity_type="item", target_entity_id=f"i{b}",
              properties={"rating": float(rng.integers(1, 11) * 0.5)})
        for a, b in zip(u.tolist(), i.tolist())
    ]
    with es.bulk():
        es.insert_batch(events, app.id)
    return st


def test_shard_masks_partition_events(tmp_path):
    """Entity-hash shards are a disjoint cover that keeps each entity
    whole, with the reference's md5 owner of every id."""
    st = _home(tmp_path / "home")
    es = st.get_event_store()
    full = es.find_columnar(app_id=1, event_names=["rate"])
    shards = [find_columnar_sharded(es, n_shards=3, shard_id=s, app_id=1,
                                    event_names=["rate"]) for s in range(3)]
    assert sum(len(s) for s in shards) == len(full)
    owners = {}
    for six, s in enumerate(shards):
        for eid in s.entity_id:
            assert owners.setdefault(eid, six) == six
    for s in range(3):
        np.testing.assert_array_equal(
            ingest.shard_mask(full.entity_id, 3, s),
            jax_shard_mask(full.entity_id, 3, s))
    with pytest.raises(ValueError, match="out of range"):
        find_columnar_sharded(es, n_shards=3, shard_id=3, app_id=1)
    st.close()


def test_id_and_owner_exchange_over_two_processes(tmp_path):
    outs = spawn(tmp_path, [{"kind": "exchange",
                             "exchange_dir": str(tmp_path / "x")}] * 2)
    want_ids = sorted({"shared", "u0", "u1", "u10", "u11"})
    for rank, out in enumerate(outs):
        assert out["ids"].tolist() == want_ids
        # every triple whose row this process owns, from both processes
        rows = np.concatenate([np.arange(12) + 100 * p for p in range(2)])
        mine = np.sort(rows[rows % 2 == rank])
        np.testing.assert_array_equal(np.sort(out["r"]), mine)
        np.testing.assert_array_equal(out["v"], out["r"].astype(np.float32))
    # each process withdrew its own files after the exchange
    assert not list((tmp_path / "x").glob("*.npz"))


def test_torn_exchange_retries_then_raises_typed_error(tmp_path):
    """One torn publish is retried under a fresh nonce; persistent
    tearing exhausts the budget as ExchangeTornError (never a hang)."""
    r = np.arange(5, dtype=np.int64)
    faults.arm("dist.exchange_torn:times=1")
    r2, c2, _ = exchange_ratings_by_owner(
        r, r * 2, np.ones(5, np.float32), np.zeros(5, np.int64), tmp_path,
        "t", retry=RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0,
                               seed=0))
    assert faults.armed().counters()["dist.exchange_torn"]["fires"] == 1
    np.testing.assert_array_equal(r2, r)
    faults.arm("dist.exchange_torn")
    with pytest.raises(ExchangeTornError, match="retry budget"):
        exchange_ratings_by_owner(
            r, r, r.astype(np.float32), np.zeros(5, np.int64), tmp_path,
            "t2", retry=RetryPolicy(max_attempts=3, base_s=0.0, cap_s=0.0,
                                    seed=0))
    assert faults.armed().counters()["dist.exchange_torn"]["calls"] == 3


def test_torn_exchange_degrades_to_replicated_trainer(tmp_path,
                                                      monkeypatch):
    def torn(*a, **k):
        raise ExchangeTornError("injected: exchange torn past retries")

    monkeypatch.setattr(ALSTrainer, "distributed", staticmethod(torn))
    st = _home(tmp_path / "home")
    before = RESILIENCE_TOTAL.labels(kind="dist.exchange_degraded").value()
    cfg = ALSConfig(rank=4, num_iterations=2, lam=0.1,
                    factor_placement="sharded", coded_shards=True)
    tr = ingest.distributed_trainer(
        st.get_event_store(), tmp_path / "x", cfg,
        make_mesh(devices=["cpu"] * 2), rating_property="rating",
        app_id=1, event_names=["rate"])
    assert tr.cfg.factor_placement == "replicated"
    assert not tr.cfg.coded_shards
    assert RESILIENCE_TOTAL.labels(
        kind="dist.exchange_degraded").value() == before + 1
    assert np.isfinite(tr.train().user_factors).all()
    st.close()


@pytest.mark.parametrize("nprocs", [2, 4])
def test_distributed_trainer_matches_jax(tmp_path, nprocs):
    """Each process holds only its share of the triples; the exchanged
    sharded-COO train equals the reference's sharded train on a mesh of
    the same size, from the reference's padded start."""
    u, i, v, nu, ni = _toy(seed=nprocs)
    kw = dict(rank=4, num_iterations=3, lam=0.05,
              factor_placement="sharded", solver="fused")
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw),
                        mesh=jax_make_mesh(nprocs))
    U0, V0 = (np.asarray(a) for a in ref.init_factors())
    want = ref.train()
    np.savez(tmp_path / "data.npz", u=u, i=i, v=v, n_users=nu, n_items=ni,
             U0=U0, V0=V0)
    outs = spawn(tmp_path, [{
        "kind": "trainer", "data": str(tmp_path / "data.npz"), "cfg": kw,
        "exchange_dir": str(tmp_path / "x")}] * nprocs, timeout=180)
    single = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw),
                        mesh=make_mesh(devices=["cpu"] * nprocs))
    for out in outs:
        assert str(out["staging"]) == "sharded-distributed"
        assert int(out["coo_shard_entries"]) == single.coo_shard_entries
        _rel_close(out["U"], want.user_factors, 1e-4)
        _rel_close(out["V"], want.item_factors, 1e-4)


def test_console_train_over_two_processes_deploys(tmp_path, monkeypatch):
    """``train --coordinator ... --num-processes 2`` through the console
    on a shared store: one instance, a sharded ``.npz`` model written by
    the chief, factors equal to a single-process train's, and a deploy
    of it answering as ``predict`` on the loaded model."""
    home = tmp_path / "home"
    _home(home).close()
    variant = {
        "id": "default", "engineFactory": FACTORY,
        "datasource": {"params": {"appName": "shop", "coo": "local"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1,
            "solver": "fused", "factorPlacement": "sharded"}}],
    }
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(variant))
    env = {"PIO_TPU_HOME": str(home),
           "PIO_TPU_COORD_DIR": str(tmp_path / "coord")}
    outs = spawn(tmp_path, [{"kind": "cli", "argv": [
        "train", "--engine-json", str(ej)]}] * 2, timeout=180, env=env)
    assert [int(o["rc"]) for o in outs] == [0, 0]
    logs = [(tmp_path / f"log-{r}.txt").read_text() for r in range(2)]
    iids = [line.rsplit(" ", 1)[1] for log in logs
            for line in log.splitlines()
            if line.startswith("Training completed")]
    assert len(iids) == 2 and iids[0] == iids[1]
    assert "joined the run over gloo" in logs[0]
    iid = iids[0]
    key = model_io.model_key(iid, 0, "als")
    st = Storage({"PIO_TPU_HOME": str(home)})
    manifest = json.loads(st.get_metadata().model_get(key).models.decode())
    assert manifest["kind"] == "sharded"
    assert (st.model_data_dir() / iid / manifest["npz"]).is_file()
    assert st.get_metadata().engine_instance_get(iid).status == "COMPLETED"
    monkeypatch.setenv("PIO_TPU_RUNLOG_DIR", str(home / "telemetry/runs"))
    view = runlog.read_manifest(runlog.runs_root() / iid)
    assert view is not None and view["header"]["workers"] == 2

    engine = recommendation_engine()
    ep = engine.params_from_variant(variant)
    (model,) = prepare_deploy(engine, ep, iid, WorkflowContext(
        device="cpu", storage=st, mode="Serving"))
    # the same store trained by one process (gathered, one shard)
    one_ep = engine.params_from_variant(dict(variant, datasource={
        "params": {"appName": "shop"}}))
    (one,) = engine.train(WorkflowContext(device="cpu", storage=st), one_ep)
    assert list(model.users.ids) == list(one.users.ids)
    _rel_close(model.user_factors, one.user_factors, 1e-4)
    _rel_close(model.item_factors, one.item_factors, 1e-4)

    from predictionio_tpu_torch.server import EngineServer, ServerConfig

    srv = EngineServer(engine, ep, iid, ctx=WorkflowContext(
        device="cpu", storage=st, mode="Serving"),
        config=ServerConfig(host="127.0.0.1", port=0))
    thread = srv.start_background()
    try:
        algo = engine._algorithms(ep)[0]
        for user in ("u0", "u5", "u11"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/queries.json",
                data=json.dumps({"user": user, "num": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())
            want = algo.predict(model, Query(user=user, num=4)).to_json()
            assert [s["item"] for s in got["itemScores"]] == \
                [s["item"] for s in want["itemScores"]]
    finally:
        srv.stop()
        thread.join(timeout=10)
    st.close()


def test_sharded_npz_crosses_between_packages(tmp_path):
    """A sharded ``.npz`` model written by the reference loads in the
    port to the same factors, and the port's loads in the reference."""
    rng = np.random.default_rng(9)
    U = rng.normal(size=(6, 3)).astype(np.float32)
    V = rng.normal(size=(5, 3)).astype(np.float32)
    users, items = [f"u{k}" for k in range(6)], [f"i{k}" for k in range(5)]
    jmodel = JaxALSModel(user_factors=U, item_factors=V,
                         users=JaxStringIndex(users),
                         items=JaxStringIndex(items), item_props={"i1": {}})
    jman = jax_model_io._save_sharded(jmodel, tmp_path / "j", "k-0-als")
    assert jman["kind"] == "sharded"
    got = model_io._load_sharded(jman, tmp_path / "j")
    assert isinstance(got, ALSModel)
    assert got.user_factors.tobytes() == U.tobytes()
    assert got.item_factors.tobytes() == V.tobytes()
    assert list(got.items.ids) == items

    from predictionio_tpu_torch.storage import StringIndex

    pmodel = ALSModel(user_factors=U, item_factors=V,
                      users=StringIndex(users), items=StringIndex(items),
                      item_props={}, device=torch.device("cpu"))
    pman = model_io._save_sharded(pmodel, tmp_path / "p", "k-0-als")
    assert pman == {"kind": "sharded", "npz": "k-0-als-arrays.npz",
                    "rest": "k-0-als-rest.pkl",
                    "specs": {"user_factors": None, "item_factors": None}}
    back = jax_model_io._load_sharded(
        type("Ctx", (), {"mesh": None})(), pman, tmp_path / "p")
    assert back.user_factors.tobytes() == U.tobytes()
    assert back.item_factors.tobytes() == V.tobytes()
    assert JaxALSAlgorithm.placement.value == ALSAlgorithm.placement.value
