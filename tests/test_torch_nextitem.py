"""The port's nextitem engine against the reference.

Seeded sessions of view events go into one home that both packages
open: the training read (the sessionizer's carry, the transition store's
CSR arrays and epoch), the cursor refresh and the eval binding agree bit
for bit when both packages' clocks are pinned to one value; model files
load across the two packages; a query without an item is anchored on
the user's last item; ``batch_predict`` answers as ``predict`` does,
after one refresh for the whole flight; a ``storage.read`` fault serves
the stale matrix; the console trains and deploys ``--engine nextitem``,
whose HTTP replies equal ``predict`` and which turns the micro-batcher
on.  Tolerance: none (bitwise) unless a test says otherwise.
"""

from __future__ import annotations

import datetime as dt
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from predictionio_tpu import sessions as ref_sessions
from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.templates import nextitem as ref
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.obs import (
    RESILIENCE_TOTAL,
    SESSION_EVENTS_TOTAL,
    SESSION_TRANSITIONS,
)
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.sessions import store as store_mod
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates import nextitem

UTC = dt.timezone.utc
NOW = 1_790_000_000.0
HL = 86_400.0


def _pin(monkeypatch, t: float = NOW) -> None:
    """Both packages' transition stores read ``t`` from the clock."""
    clock = types.SimpleNamespace(time=lambda: t, monotonic=time.monotonic)
    monkeypatch.setattr(store_mod, "time", clock)
    monkeypatch.setattr(ref_sessions.store, "time", clock)


def _sessions(seed: int, users: int = 30, items: int = 15,
              t_end: float = NOW) -> list:
    """Per user 1 to 4 sessions of 1 to 6 views, 5 to 120 s apart inside
    a session and over 1,800 s between sessions; each next item one of
    three successors of the last, or a restart."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, items, size=(items, 3))
    out = []
    for u in range(users):
        t = t_end - float(rng.uniform(20_000.0, 60_000.0))
        for _ in range(int(rng.integers(1, 5))):
            item = int(rng.integers(0, items))
            for _ in range(int(rng.integers(1, 7))):
                out.append((f"u{u}", f"i{item}", t))
                t += float(rng.uniform(5.0, 120.0))
                item = int(succ[item, rng.integers(0, 3)]) \
                    if rng.random() > 0.2 else int(rng.integers(0, items))
            t += float(rng.uniform(1_801.0, 5_000.0))
    rng.shuffle(out)
    return out


def _views(triples) -> list:
    return [Event(event="view", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  event_time=dt.datetime.fromtimestamp(t, UTC))
            for u, i, t in triples]


def _homes(tmp_path, triples, app_name: str = "shop"):
    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    app = st.get_metadata().app_insert(app_name)
    es = st.get_event_store()
    es.init_channel(app.id)
    es.insert_batch(_views(triples), app_id=app.id)
    return st, RefStorage(env={"PIO_TPU_HOME": str(tmp_path)}), app.id


def _variant(**ds) -> dict:
    return {"datasource": {"params": {"appName": "shop", "halfLifeSec": HL,
                                      "eventNames": ["view"], **ds}},
            "algorithms": [{"name": "nextitem", "params": {}}]}


def _same_model(a, b) -> None:
    assert a.cursor == b.cursor
    assert a.sessionizer.to_doc() == b.sessionizer.to_doc()
    assert a.store._pending == b.store._pending
    assert json.dumps(a.store.to_doc()) == json.dumps(b.store.to_doc())


def _trained(tmp_path, monkeypatch, **ds):
    """Each package's algorithm and model trained on the same home."""
    _pin(monkeypatch)
    st, ref_st, app_id = _homes(tmp_path, _sessions(0))
    out = []
    for pkg, ctx in ((nextitem, WorkflowContext(device="cpu", storage=st)),
                     (ref, RefContext(storage=ref_st))):
        engine = pkg.nextitem_engine()
        ep = engine.params_from_variant(_variant(**ds))
        td = engine._data_source(ep).read_training(ctx)
        algo = engine._algorithms(ep)[0]
        algo._ctx = ctx
        out.append((algo, algo.train(ctx, td)))
    return st, app_id, out


def test_train_equals_the_references(tmp_path, monkeypatch):
    st, _, ((_, m), (_, rm)) = _trained(tmp_path, monkeypatch)
    assert m.store.t0 == NOW and m.store.half_life_s == HL
    assert m.store.transitions_folded > 100
    _same_model(m, rm)
    for src in ("i0", "i4", "i9"):
        assert m.store.top_successors(src, 5, now=NOW) == \
            rm.store.top_successors(src, 5, now=NOW)


def test_refresh_equals_the_references_and_books_the_session_metrics(
        tmp_path, monkeypatch):
    """New views continue open sessions and start new ones; one forced
    refresh folds them into both models alike, exactly once."""
    st, app_id, ((_, m), (_, rm)) = _trained(tmp_path, monkeypatch,
                                             refreshSec=0.0)
    last = {u: max(t for uu, _, t in _sessions(0) if uu == u)
            for u in ("u0", "u1", "u2")}
    fresh = [(u, f"i{k}", t + 10.0 * (k + 1)) for u, t in last.items()
             for k in range(3)] + [("newbie", "i1", NOW), ("newbie", "i2",
                                                            NOW + 3.0)]
    st.get_event_store().insert_batch(_views(fresh), app_id=app_id)
    app = str(app_id)
    before = SESSION_EVENTS_TOTAL.labels(app=app).value()
    assert m.refresh(st.get_event_store(), force=True) == len(fresh)
    ref_es = RefStorage(env={"PIO_TPU_HOME": str(tmp_path)}).get_event_store()
    assert rm.refresh(ref_es, force=True) == len(fresh)
    _same_model(m, rm)
    assert SESSION_EVENTS_TOTAL.labels(app=app).value() == before + len(fresh)
    assert SESSION_TRANSITIONS.labels(app=app).value() == m.store.n_pairs
    assert m.refresh(st.get_event_store(), force=True) == 0
    assert m.sessionizer.last_item("newbie") == "i2"


def test_a_query_without_an_item_is_anchored_on_the_users_last_item(
        tmp_path, monkeypatch):
    st, _, ((algo, m), (ralgo, rm)) = _trained(tmp_path, monkeypatch,
                                               refreshSec=-1.0)
    user = "u3"
    last = m.sessionizer.last_item(user)
    got = algo.predict(m, nextitem.Query(user=user, num=4))
    assert got == algo.predict(m, nextitem.Query(item=last, num=4))
    assert got.item_scores
    want = ralgo.predict(rm, ref.Query(user=user, num=4))
    assert [(s.item, s.score) for s in got.item_scores] == [
        (s.item, s.score) for s in want.item_scores]
    assert m.anchor_for(nextitem.Query(user="nobody")) is None
    assert algo.predict(m, nextitem.Query(user="nobody")).item_scores == ()
    assert algo.predict(m, nextitem.Query()).item_scores == ()


def test_batch_predict_equals_predict_after_one_refresh(tmp_path,
                                                        monkeypatch):
    st, _, ((algo, m), _) = _trained(tmp_path, monkeypatch, refreshSec=0.0)
    queries = [nextitem.Query(item=f"i{k}", num=3) for k in range(15)] + [
        nextitem.Query(user=f"u{k}", num=5, blacklist=("i1",))
        for k in range(10)]
    refreshes = m.refreshes
    got = algo.batch_predict(m, queries)
    assert m.refreshes == refreshes + 1
    assert got == [algo._predict_fresh(m, q) for q in queries]
    assert got == [algo.predict(m, q) for q in queries]
    assert sum(bool(r.item_scores) for r in got) > 15


def test_model_files_load_across_packages(tmp_path, monkeypatch):
    _, _, ((algo, m), (ralgo, rm)) = _trained(tmp_path, monkeypatch)
    d = tmp_path / "models"
    mine = algo.save_model(None, "port", m, d)
    theirs = ralgo.save_model(None, "ref", rm, d)
    assert json.loads((d / mine["json"]).read_text()) == json.loads(
        (d / theirs["json"]).read_text())
    _same_model(algo.load_model(None, "ref", theirs, d),
                ralgo.load_model(None, "port", mine, d))
    back = algo.load_model(None, "ref", theirs, d)
    assert (back.app_id, back.event_names, back.refresh_s) == (
        m.app_id, ("view",), 2.0)


def test_a_storage_read_fault_serves_the_stale_matrix(tmp_path, monkeypatch):
    st, app_id, ((algo, m), _) = _trained(tmp_path, monkeypatch,
                                          refreshSec=0.0)
    before = RESILIENCE_TOTAL.labels(kind="nextitem.stale_serve").value()
    want = algo._predict_fresh(m, nextitem.Query(item="i2", num=5))
    st.get_event_store().insert_batch(
        _views([("z", "i2", NOW), ("z", "zz", NOW + 1.0)]), app_id=app_id)
    faults.arm("storage.read")
    try:
        assert algo.predict(m, nextitem.Query(item="i2", num=5)) == want
        assert m.stale is True
    finally:
        faults.disarm()
    assert RESILIENCE_TOTAL.labels(
        kind="nextitem.stale_serve").value() == before + 1
    got = algo.predict(m, nextitem.Query(item="i2", num=5))
    assert m.stale is False and "zz" in [s.item for s in got.item_scores]


def test_the_eval_binding_equals_the_references(tmp_path, monkeypatch):
    _pin(monkeypatch)
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    from predictionio_tpu.workflow.evaluate import (
        run_evaluation as ref_run_evaluation,
    )
    from predictionio_tpu_torch.engines import get_engine_spec
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    st, ref_st, _ = _homes(tmp_path, _sessions(1, users=40))
    assert get_engine_spec("nextitem").evaluation is \
        nextitem.nextitem_evaluation
    results = []
    for pkg, run, ctx in (
            (nextitem, run_evaluation, WorkflowContext(
                device="cpu", storage=st, mode="Evaluation")),
            (ref, ref_run_evaluation, RefContext(storage=ref_st,
                                                 mode="Evaluation"))):
        ev = pkg.nextitem_evaluation(app_name="shop", k=3, holdout=0.3)
        ep = ev.engine_params_list[0]
        ((td, info, qa),) = ev.engine._data_source(ep).read_eval(ctx)
        ev.output_path = str(tmp_path / "best.json")
        _, result = run(ev, None, ctx=ctx)
        results.append((json.dumps(td.store.to_doc()),
                        td.sessionizer.to_doc(), info,
                        [(q.item, q.num, a.items) for q, a in qa],
                        result.metric_header, result.best_score))
    assert results[0] == results[1]
    assert results[0][4] == "MAP@3" and 0.0 < results[0][5] <= 1.0


def test_the_console_trains_and_deploys_nextitem_and_it_batches(
        tmp_path, monkeypatch):
    """``train --engine nextitem`` and ``deploy --engine nextitem`` on
    the CPU: HTTP replies from 8 clients equal in-process ``predict`` at
    the pinned clock, and the server's micro-batcher is on."""
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.engines import resolve
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    _pin(monkeypatch)
    st, _, _ = _homes(tmp_path, _sessions(2), app_name="MyApp")
    assert main(["train", "--engine", "nextitem"], storage=st,
                device="cpu") == 0
    pf = tmp_path / "port"
    rcs = []
    thread = threading.Thread(target=lambda: rcs.append(main(
        ["deploy", "--engine", "nextitem", "--ip", "127.0.0.1", "--port",
         "0", "--port-file", str(pf)], storage=st, device="cpu")),
        daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not (pf.exists() and pf.read_text().endswith("\n")):
        assert thread.is_alive() and time.monotonic() < deadline
        time.sleep(0.05)
    base = f"http://127.0.0.1:{int(pf.read_text())}"
    (iid,) = [r.id for r in st.get_metadata().engine_instance_get_all()]
    engine, ep, _ = resolve("nextitem")
    algos, models, _ = prepare_deploy_components(
        engine, ep, iid, ctx=WorkflowContext(device="cpu", storage=st,
                                             mode="Serving"))
    queries = [{"item": f"i{k}", "num": 4} for k in range(15)] + [
        {"user": f"u{k}", "num": 3} for k in range(17)]

    def ask(q):
        req = urllib.request.Request(
            f"{base}/queries.json", data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(ask, queries))
    assert got == [algos[0].predict(
        models[0], nextitem.Query.from_json(q)).to_json() for q in queries]
    with urllib.request.urlopen(f"{base}/", timeout=60) as r:
        assert json.loads(r.read())["microbatch"]["requests"] == len(queries)
    assert main(["undeploy", "--port", base.rsplit(":", 1)[1]],
                storage=st) == 0
    thread.join(timeout=30)
    assert rcs == [0]


def test_the_wire_format_and_params_equal_the_references():
    for d in ({"user": "u1", "item": "a", "num": 5, "blackList": ["x"]},
              {"user": 7}, {}):
        got, want = nextitem.Query.from_json(d), ref.Query.from_json(d)
        assert (got.user, got.item, got.num, got.blacklist) == (
            want.user, want.item, want.num, want.blacklist)
    for bad in ({"sessionGapSec": 0.0}, {"halfLifeSec": -1.0},
                {"evalHoldout": 1.0}):
        with pytest.raises(ValueError):
            nextitem.nextitem_engine().params_from_variant(_variant(**bad))
