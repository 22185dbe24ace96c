"""The port's trending engine against the reference.

Seeded view events go into one store that both packages open (the
single file and the 4-shard store): the decayed scan, the training read,
the cursor refresh, the rebase, the ranked list and the eval binding
agree bit for bit when both packages' clocks are pinned to one value;
model files load across the two packages; a ``storage.read`` fault
serves the stale list and books ``trending.stale_serve``; the console
trains and deploys ``--engine trending``, whose HTTP reply equals
``predict`` and which keeps the micro-batcher off.  Tolerance: none
(bitwise) unless a test says otherwise.
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

from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage import (
    ShardedSQLiteEventStore as RefShardedStore,
)
from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as RefSQLiteStore,
)
from predictionio_tpu.templates import trending as ref
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.obs import RESILIENCE_TOTAL
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.storage import (
    Event,
    ShardedSQLiteEventStore,
    SQLiteEventStore,
    Storage,
)
from predictionio_tpu_torch.templates import trending

UTC = dt.timezone.utc
NOW = 1_790_000_000.0
HL = 3_600.0


def _pin(monkeypatch, t: float = NOW) -> None:
    """Both packages' trending modules read ``t`` from the clock."""
    clock = types.SimpleNamespace(time=lambda: t, monotonic=time.monotonic)
    monkeypatch.setattr(trending, "time", clock)
    monkeypatch.setattr(ref, "time", clock)


def _views(seed: int, n: int = 300, items: int = 25, span: float = 20_000.0,
           now: float = NOW) -> list:
    """Views in the ``span`` seconds before ``now``: Zipf-ish items,
    times drawn uniformly (so out of insertion order)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, items + 1)
    p /= p.sum()
    return [Event(event=str(rng.choice(["view", "view", "buy"])),
                  entity_type="user",
                  entity_id=f"u{int(rng.integers(0, 40))}",
                  target_entity_type="item",
                  target_entity_id=f"i{int(rng.choice(items, p=p))}",
                  event_time=dt.datetime.fromtimestamp(
                      now - float(rng.uniform(0.0, span)), UTC))
            for _ in range(n)]


def _file(tmp_path, seed: int = 0):
    es = SQLiteEventStore(tmp_path / "e.db")
    es.init_channel(1)
    es.insert_batch(_views(seed), app_id=1)
    return es, RefSQLiteStore(tmp_path / "e.db")


def _model(pkg, w, cursor, refresh_s=0.0):
    ids = sorted(w)
    return pkg.TrendingModel(ids, np.asarray([w[i] for i in ids]), NOW,
                             cursor, 1, 0, ("view", "buy"), HL,
                             refresh_s=refresh_s)


def _same_model(a, b) -> None:
    assert a.item_ids == b.item_ids and a.t0 == b.t0
    assert a.cursor == b.cursor
    assert a.weights.tobytes() == b.weights.tobytes()


@pytest.mark.parametrize("page", [50_000, 7])
def test_scan_decayed_equals_the_references_bitwise(tmp_path, page):
    es, ref_es = _file(tmp_path)
    got = trending.scan_decayed(es, 1, 0, 0, ("view", "buy"), HL, NOW,
                                page=page)
    want = ref.scan_decayed(ref_es, 1, 0, 0, ("view", "buy"), HL, NOW,
                            page=page)
    assert got == want and got[2] == 300
    # each weight against a float64 sum over the rows, in row order
    rows, _ = es.find_rows_since(1, 0, cursor=0, event_names=["view", "buy"])
    sums = {}
    for r in rows:
        sums[r[6]] = sums.get(r[6], 0.0) + 2.0 ** ((r[8] / 1000.0 - NOW) / HL)
    assert got[0] == sums


def test_the_parallel_sharded_scan_is_bitwise_the_paged_and_the_references(
        tmp_path):
    es = ShardedSQLiteEventStore(tmp_path / "sh", n_shards=4)
    es.init_channel(1)
    es.insert_batch(_views(1), app_id=1)

    class Paged:
        """The sharded store without its parallel scan."""

        def find_rows_since(self, *a, **kw):
            kw.pop("parallel", None)
            return es.find_rows_since(*a, **kw)

    # the unbounded scan walks the shards in turn on the calling thread
    threads = []
    for shard in es.shards:
        def on_thread(*a, _scan=shard.find_rows_since, **kw):
            threads.append(threading.get_ident())
            return _scan(*a, **kw)
        shard.find_rows_since = on_thread
    par = trending.scan_decayed(es, 1, 0, 0, ("view", "buy"), HL, NOW)
    assert threads == [threading.get_ident()] * 4
    paged = trending.scan_decayed(Paged(), 1, 0, 0, ("view", "buy"), HL,
                                  NOW, page=1_000)
    want = ref.scan_decayed(RefShardedStore(tmp_path / "sh", n_shards=4),
                            1, 0, 0, ("view", "buy"), HL, NOW)
    assert par == paged == want and par[2] == 300


def _homes(tmp_path, events, app_name: str = "shop"):
    """One home, opened by each package's ``Storage``, holding an app
    and ``events``."""
    st = Storage({"PIO_TPU_HOME": str(tmp_path)})
    app = st.get_metadata().app_insert(app_name)
    es = st.get_event_store()
    es.init_channel(app.id)
    es.insert_batch(events, app_id=app.id)
    return st, RefStorage(env={"PIO_TPU_HOME": str(tmp_path)}), app.id


def _variant(**ds) -> dict:
    return {"datasource": {"params": {"appName": "shop",
                                      "halfLifeSec": HL, **ds}},
            "algorithms": [{"name": "trending", "params": {}}]}


def test_train_and_refresh_equal_the_references(tmp_path, monkeypatch):
    """The training read, then a burst of a cold item's views folded by
    a forced refresh from the cursor: the same weights, epoch, cursor
    and list in both; a second refresh folds nothing."""
    _pin(monkeypatch)
    st, ref_st, app_id = _homes(tmp_path, _views(2))
    models = []
    for pkg, storage, ctx in (
            (trending, st, WorkflowContext(device="cpu", storage=st)),
            (ref, ref_st, RefContext(storage=ref_st))):
        engine = pkg.trending_engine()
        ep = engine.params_from_variant(_variant(refreshSec=0.0))
        td = engine._data_source(ep).read_training(ctx)
        algo = engine._algorithms(ep)[0]
        models.append((algo.train(ctx, td), storage))
    (m, st), (rm, ref_st) = models
    _same_model(m, rm)
    assert m.t0 == NOW and m.half_life_s == HL and m.refresh_s == 0.0
    burst = [Event(event="view", entity_type="user", entity_id=f"b{k}",
                   target_entity_type="item", target_entity_id="cold",
                   event_time=dt.datetime.fromtimestamp(NOW, UTC))
             for k in range(80)]
    st.get_event_store().insert_batch(burst, app_id=app_id)
    assert m.refresh(st.get_event_store(), force=True) == 80
    assert rm.refresh(ref_st.get_event_store(), force=True) == 80
    _same_model(m, rm)
    assert m.top(5) == rm.top(5) and m.top(5)[0][0] == "cold"
    assert m.refresh(st.get_event_store(), force=True) == 0
    assert (m.events_folded, m.refreshes) == (80, 2)


def test_rebase_equals_the_references_and_keeps_the_ranking(monkeypatch):
    """An epoch 700 half-lives old: merged weights near 2**700 rebase to
    the pinned clock in both, and the ranking survives."""
    _pin(monkeypatch)
    hl = 10.0
    out = []
    for pkg in (trending, ref):
        m = pkg.TrendingModel(["a", "b"], np.asarray([4.0, 1.0]),
                              NOW - 700 * hl, 0, 1, 0, ("view",),
                              half_life_s=hl, refresh_s=-1.0)
        m._merge_locked({"a": 2.0 ** 699, "c": 2.0 ** 700}, cursor=5)
        out.append(m)
    m, rm = out
    _same_model(m, rm)
    assert m.t0 == NOW and np.log2(m.weights.max()) < 65
    assert [i for i, _ in m.top(3)] == ["c", "a", "b"]
    assert m.top(3) == rm.top(3)


def test_top_and_its_black_list_equal_the_references(monkeypatch):
    _pin(monkeypatch, NOW + 1_234.5)
    rng = np.random.default_rng(3)
    ids = [f"i{k}" for k in range(60)]
    w = np.round(rng.exponential(size=60), 1)   # ties on purpose
    w[:5] = 0.0
    m = trending.TrendingModel(ids, w, NOW, 0, 1, 0, ("view",), HL, -1.0)
    rm = ref.TrendingModel(ids, w, NOW, 0, 1, 0, ("view",), HL, -1.0)
    for k in (0, 1, 10, 55, 60, 100):
        for bl in ((), ("i7", "i9"), tuple(ids[10:])):
            assert m.top(k, blacklist=bl) == rm.top(k, blacklist=bl)
    assert m.top(100, blacklist=tuple(ids)) == []
    assert all(s > 0 for _, s in m.top(100))


def test_model_files_load_across_packages(tmp_path):
    out = {}
    for name, pkg in (("port", trending), ("ref", ref)):
        m = pkg.TrendingModel(["a", "b"], np.asarray([2.5, 1.5]), 123.0,
                              '{"0":4,"1":7}', 9, 2, ("view", "buy"), HL,
                              refresh_s=3.0, scan_page=77)
        out[name] = pkg.TrendingAlgorithm().save_model(
            None, f"m-{name}", m, tmp_path)
    assert json.loads((tmp_path / out["port"]["json"]).read_text()) == \
        json.loads((tmp_path / out["ref"]["json"]).read_text())
    got = trending.TrendingAlgorithm().load_model(
        None, "m-ref", out["ref"], tmp_path)
    back = ref.TrendingAlgorithm().load_model(
        None, "m-port", out["port"], tmp_path)
    _same_model(got, back)
    assert (got.event_names, got.app_id, got.channel_id, got.refresh_s,
            got.scan_page) == (("view", "buy"), 9, 2, 3.0, 77)


def _stale_count() -> float:
    return RESILIENCE_TOTAL.labels(kind="trending.stale_serve").value()


def test_a_storage_read_fault_serves_the_stale_list(tmp_path):
    es, _ = _file(tmp_path)
    w, cur, _ = trending.scan_decayed(es, 1, 0, 0, ("view", "buy"), HL, NOW)
    m = _model(trending, w, cur)
    before, top = _stale_count(), m.top(3)
    es.insert_batch([Event(event="view", entity_type="user", entity_id="x",
                           target_entity_type="item", target_entity_id="new")],
                    app_id=1)
    faults.arm("storage.read")
    try:
        assert m.refresh(es, force=True) == 0
        assert m.stale is True and m.cursor == cur
        assert [i for i, _ in m.top(3)] == [i for i, _ in top]
    finally:
        faults.disarm()
    assert _stale_count() == before + 1
    assert m.refresh(es, force=True) == 1 and m.stale is False
    assert "new" in m.item_ids


def test_the_eval_binding_equals_the_references(tmp_path, monkeypatch):
    """``eval --engine trending``'s evaluation: the time-split read and
    MAP@k of the same events in both packages."""
    _pin(monkeypatch)
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    from predictionio_tpu.workflow.evaluate import (
        run_evaluation as ref_run_evaluation,
    )
    from predictionio_tpu_torch.engines import get_engine_spec
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    st, ref_st, _ = _homes(tmp_path, _views(4, n=200, items=8))
    assert get_engine_spec("trending").evaluation is \
        trending.trending_evaluation
    results = []
    for pkg, run, ctx in (
            (trending, run_evaluation, WorkflowContext(
                device="cpu", storage=st, mode="Evaluation")),
            (ref, ref_run_evaluation, RefContext(storage=ref_st,
                                                 mode="Evaluation"))):
        ev = pkg.trending_evaluation(app_name="shop", k=5, holdout=0.25)
        ep = ev.engine_params_list[0]
        ((td, info, qa),) = ev.engine._data_source(ep).read_eval(ctx)
        ev.output_path = str(tmp_path / "best.json")
        _, result = run(ev, None, ctx=ctx)
        results.append((td.weights, td.t0, info,
                        [(q.num, a.items) for q, a in qa],
                        result.metric_header, result.best_score))
    assert results[0] == results[1]
    assert results[0][4] == "MAP@5" and 0.0 < results[0][5] <= 1.0


def test_the_console_trains_and_deploys_trending(tmp_path, monkeypatch):
    """``train --engine trending`` and ``deploy --engine trending`` as a
    user runs them (on the CPU); the HTTP reply equals an in-process
    ``predict`` at the pinned clock, and the server keeps the
    micro-batcher off (trending overrides no ``batch_predict``)."""
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.engines import resolve
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    _pin(monkeypatch)
    st, _, _ = _homes(tmp_path, _views(5), app_name="MyApp")
    assert main(["train", "--engine", "trending"], storage=st,
                device="cpu") == 0
    pf = tmp_path / "port"
    rcs = []
    thread = threading.Thread(target=lambda: rcs.append(main(
        ["deploy", "--engine", "trending", "--ip", "127.0.0.1", "--port",
         "0", "--port-file", str(pf)], storage=st, device="cpu")),
        daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not (pf.exists() and pf.read_text().endswith("\n")):
        assert thread.is_alive() and time.monotonic() < deadline
        time.sleep(0.05)
    port = int(pf.read_text())
    base = f"http://127.0.0.1:{port}"
    (iid,) = [r.id for r in st.get_metadata().engine_instance_get_all()]
    engine, ep, _ = resolve("trending")
    algos, models, _ = prepare_deploy_components(
        engine, ep, iid, ctx=WorkflowContext(device="cpu", storage=st,
                                             mode="Serving"))
    for q in ({"num": 4}, {"num": 10, "blackList": ["i0", "i1"]}):
        req = urllib.request.Request(
            f"{base}/queries.json", data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        want = algos[0].predict(models[0],
                                trending.Query.from_json(q)).to_json()
        assert got == want and got["itemScores"]
    with urllib.request.urlopen(f"{base}/", timeout=60) as r:
        assert "microbatch" not in json.loads(r.read())
    assert main(["undeploy", "--port", str(port)], storage=st) == 0
    thread.join(timeout=30)
    assert rcs == [0]
