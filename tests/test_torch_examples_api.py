"""The port's examples that use only the package's API (``helloworld``,
``friendrec``, ``markovchain``, ``lambda-sweep``, ``movielens-eval``,
``recommendation-cat``, ``similarproduct-local``, ``trim-app``) against
the reference's ``engine.py`` beside each, on the same data files and
queries, on the host.

Every ALS train of the port starts from the JAX trainer's initial
factors (``start_from_jax``); then each half's factors must agree within
1e-4 of their scale, the training RMSE within 1e-5 relative, and the
served top-K within 1e-4 of the scores' scale with equal ids outside
ties.  The rest (averages, keyword products, chain probabilities) must
agree within 1e-6 relative.  Every assertion that
``tests/test_examples.py`` makes of an example holds on the port's
answers too.
"""

import datetime as dt
import json
from pathlib import Path

import numpy as np
import pytest

from torch_examples_common import (
    EXAMPLES,
    MEMORY,
    contexts,
    example,
    one_torch_thread,
    same_als,
    same_ranking,
    start_from_jax,
    train_both,
    variant,
)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture()
def same_start(monkeypatch):
    start_from_jax(monkeypatch)


def _algo(engine, ep):
    return engine._algorithms(ep)[0]


def test_every_engine_torch_json_names_the_port():
    """Each ``engine_torch.json`` is its ``engine.json`` with the port's
    factory, and every example has its counterpart module."""
    names = sorted(p.name for p in EXAMPLES.iterdir() if p.is_dir())
    assert len(names) == 18
    for name in names:
        d = EXAMPLES / name
        assert (d / "engine_torch.py").is_file(), name
        if not (d / "engine.json").exists():
            assert not (d / "engine_torch.json").exists(), name
            continue
        want = variant(d / "engine.json")
        got = variant(d / "engine_torch.json")
        assert want.pop("engineFactory") == "engine.engine_factory"
        assert got.pop("engineFactory") == "engine_torch.engine_factory"
        assert got == want, name


def test_helloworld():
    with example("helloworld") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        for day in ("Mon", "Tue"):
            want = _algo(je, jep).predict(jm[0], ref.Query(day=day))
            got = _algo(pe, pep).predict(pm[0], port.Query(day=day))
            assert got.temperature == pytest.approx(want.temperature,
                                                    rel=1e-6)
        r = _algo(pe, pep).predict(pm[0], port.Query(day="Mon"))
        assert r.temperature == pytest.approx((75 + 62) / 2)


def test_friendrec():
    with example("friendrec") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        pairs = [(u, i) for u in ("alice", "bob", "carol", "nobody")
                 for i in ("jazz-club", "trail-group", "nowhere")]
        got = algo.batch_predict(pm[0], [port.Query(*p) for p in pairs])
        want = jalgo.batch_predict(jm[0], [ref.Query(*p) for p in pairs])
        assert [(g.confidence, g.acceptance) for g in got] == pytest.approx(
            [(w.confidence, w.acceptance) for w in want], rel=1e-6)
        # the assertions of tests/test_examples.py
        r = algo.predict(pm[0], port.Query(user="alice", item="jazz-club"))
        assert r.confidence == pytest.approx(2.0) and r.acceptance
        r = algo.predict(pm[0], port.Query(user="carol", item="jazz-club"))
        assert r.confidence == 0.0 and not r.acceptance
        r = algo.predict(pm[0], port.Query(user="nobody", item="jazz-club"))
        assert r.confidence == 0.0 and not r.acceptance
        qs = [port.Query(user="alice", item="jazz-club"),
              port.Query(user="bob", item="trail-group")]
        batch = algo.batch_predict(pm[0], qs)
        singles = [algo.predict(pm[0], q) for q in qs]
        assert [b.confidence for b in batch] == pytest.approx(
            [s.confidence for s in singles])


def test_markovchain():
    with example("markovchain") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        for state in ("home", "search", "product", "cart", "checkout",
                      "nope"):
            got = _algo(pe, pep).predict(pm[0], port.Query(state=state))
            want = _algo(je, jep).predict(jm[0], ref.Query(state=state))
            same_ranking(got, want, tol=1e-6)
        ranked = _algo(pe, pep).predict(pm[0], port.Query(state="search"))
        assert ranked and ranked[0][0] == "product"


def test_lambda_sweep(same_start, capsys):
    from predictionio_tpu.models.als import sweep_train_als as jax_sweep
    from predictionio_tpu_torch.models.als import sweep_train_als

    with example("lambda-sweep") as (ref, port):
        u, i, v, nu, ni = port.load_ratings(port.HERE / "ratings.csv")
        cfg = dict(rank=6, num_iterations=10)
        got = sweep_train_als((u, i, v), nu, ni, port.ALSConfig(**cfg),
                              lams=port.LAMBDAS, device="cpu")
        want = jax_sweep((u, i, v), nu, ni,
                         ref.ALSConfig(**cfg), lams=ref.LAMBDAS)
        for g, w in zip(got, want):
            same_als((g.user_factors, g.item_factors),
                     (np.asarray(w.user_factors), np.asarray(w.item_factors)),
                     (u, i, v))
        # the main's table, as tests/test_examples.py reads it
        port.main(["--device", "cpu"])
        out = capsys.readouterr().out
        assert "best lambda" in out
        for lam in port.LAMBDAS:
            assert f"{lam:>8}" in out
        best = float(out.rsplit("best lambda = ", 1)[1].split()[0])
        assert best in (0.05, 0.1)


def test_movielens_eval(same_start, tmp_path, monkeypatch):
    from predictionio_tpu.workflow import run_evaluation as jax_run
    from predictionio_tpu_torch.workflow import run_evaluation

    with example("movielens-eval") as (ref, port):
        data = str(Path("ratings.csv").resolve())
        # best.json lands in a scratch directory
        monkeypatch.chdir(tmp_path)
        jctx, pctx = contexts(mode="Evaluation")
        results = []
        for mod, run, ctx in ((ref, jax_run, jctx), (port, run_evaluation,
                                                     pctx)):
            candidates = [
                type(ep)(data_source=("", type(ep.data_source[1])(
                    path=data)), algorithms=ep.algorithms)
                for ep in mod.engine_params_list()
            ]
            results.append(run(mod.evaluation_factory(), candidates,
                               ctx=ctx)[1])
    want, got = results
    assert got.metric_header == want.metric_header == "MSE"
    scores = [s for _, s, _ in got.results]
    assert scores == pytest.approx([s for _, s, _ in want.results],
                                   rel=1e-5)
    assert got.best_index == want.best_index
    assert all(s == s for s in scores)
    assert got.best_engine_params.algorithms[0][1].rank == 6
    assert got.best_score == min(scores)


def _items(pred) -> list:
    return [(s.item, s.score) for s in pred.item_scores]


def test_recommendation_cat(same_start):
    with example("recommendation-cat") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        ratings = pe._data_source(pep).read_training(contexts()[1]).ratings
        same_als((pm[0].user_factors, pm[0].item_factors),
                 (jm[0].user_factors, jm[0].item_factors),
                 (ratings.user_ix, ratings.item_ix, ratings.rating))
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        queries = [dict(user="u0", num=5),
                   dict(user="u3", num=3, categories=("drama",)),
                   dict(user="u0", num=3, categories=("drama",),
                        blacklist=("m2",)),
                   dict(user="nobody", num=4)]
        for q in queries:
            same_ranking(_items(algo.predict(pm[0], port.Query(**q))),
                         _items(jalgo.predict(jm[0], ref.Query(**q))))
        r = algo.predict(pm[0], port.Query(user="u0", num=5))
        assert len(r.item_scores) == 5
        dramas = {"m2", "m3", "m6", "m7"}
        r = algo.predict(pm[0], port.Query(user="u0", num=3,
                                           categories=("drama",)))
        assert r.item_scores and {s.item for s in r.item_scores} <= dramas
        r = algo.predict(pm[0], port.Query(user="u0", num=3,
                                           categories=("drama",),
                                           blacklist=("m2",)))
        assert {s.item for s in r.item_scores} <= dramas - {"m2"}


def test_similarproduct_local(same_start):
    from predictionio_tpu_torch.controller import ModelPlacement

    with example("similarproduct-local") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        assert algo.placement is ModelPlacement.HOST
        model = pm[0]
        assert isinstance(model.item_factors, np.ndarray)
        # the local model keeps the item half alone (no training RMSE
        # without the user half): it must agree within 1e-4 of its scale
        assert np.abs(model.item_factors - jm[0].item_factors).max() <= (
            1e-4 * np.abs(jm[0].item_factors).max())
        for q in (dict(items=("phone",), num=3),
                  dict(items=("phone", "laptop"), num=2),
                  dict(items=("nothere",))):
            got = [(s.item, s.score)
                   for s in algo.predict(model, port.Query(**q))]
            want = [(s.item, s.score)
                    for s in jalgo.predict(jm[0], ref.Query(**q))]
            same_ranking(got, want)
        r = algo.predict(model, port.Query(items=("phone",), num=3))
        got = [s.item for s in r]
        assert len(r) == 3 and "phone" not in got
        assert set(got[:2]) <= {"laptop", "tablet", "camera"}, got
        assert algo.predict(model, port.Query(items=("nothere",))) == []


def _trim_store(days, events_mod, storage):
    UTC = dt.timezone.utc
    es = storage.get_event_store()
    for day in days:
        es.insert(events_mod.Event(
            event="rate", entity_type="user", entity_id=f"u{day}",
            target_entity_type="item", target_entity_id="i1",
            properties=events_mod.DataMap({"rating": 3.0}),
            event_time=dt.datetime(2020, 1, day, tzinfo=UTC)), app_id=1)
    return es


def test_trim_app():
    from predictionio_tpu.storage import event as jax_event
    from predictionio_tpu_torch.storage import event as port_event

    copied = {}
    with example("trim-app") as (ref, port):
        jctx, pctx = contexts()
        for kind, mod, ctx, ev, ej in (
                ("jax", ref, jctx, jax_event, "engine.json"),
                ("torch", port, pctx, port_event, "engine_torch.json")):
            es = _trim_store((1, 2, 3, 4, 5), ev, ctx.storage)
            engine = mod.engine_factory()
            ep = engine.params_from_variant(variant(ej))
            summary = engine.train(ctx, ep)[0]
            copied[kind] = (summary.copied, sorted(
                e.entity_id for e in es.find(app_id=2)))
            # event ids preserved across the copy
            src_ids = {e.event_id for e in es.find(app_id=1)}
            assert {e.event_id for e in es.find(app_id=2)} <= src_ids
            # refuses a non-empty destination
            with pytest.raises(RuntimeError, match="not empty"):
                engine.train(ctx, ep)
    # window [Jan 2, Jan 4): days 2 and 3 only
    assert copied["torch"] == copied["jax"] == (2, ["u2", "u3"])


def test_trim_app_failed_copy_leaves_dst_empty():
    """A failure mid-copy leaves the destination empty on the port's
    non-transactional memory store too, so a retry works."""
    from predictionio_tpu_torch.storage import Storage
    from predictionio_tpu_torch.storage import event as port_event

    with example("trim-app") as (_, port):
        from predictionio_tpu_torch.controller import WorkflowContext

        ctx = WorkflowContext(device="cpu", storage=Storage(env=MEMORY))
        es = _trim_store((2, 3), port_event, ctx.storage)
        engine = port.engine_factory()
        ep = engine.params_from_variant(variant("engine_torch.json"))
        real = es.insert_batch

        def boom(events, app_id, *a, **kw):
            if app_id == 2:
                real(events[:1], app_id, *a, **kw)  # partial write, then die
                raise OSError("disk full")
            return real(events, app_id, *a, **kw)

        es.insert_batch = boom
        try:
            with pytest.raises(OSError):
                engine.train(ctx, ep)
        finally:
            es.insert_batch = real
        assert list(es.find(app_id=2)) == []  # cleaned up
        assert engine.train(ctx, ep)[0].copied == 2  # the retry succeeds


def test_console_trains_and_serves_an_example(tmp_path):
    """``pio-tpu-torch build``/``train``/``deploy`` from an example's
    directory on its ``engine_torch.json``: the console's answer is the
    in-process ``predict``'s."""
    import threading
    import time
    import urllib.request

    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.storage import Storage

    st = Storage({"PIO_TPU_HOME": str(tmp_path / "home")})
    with example("helloworld") as (_, port):
        ej = ["--engine-json", "engine_torch.json"]
        assert main(["build", *ej], storage=st, device="cpu") == 0
        assert main(["train", *ej], storage=st, device="cpu") == 0
        port_file = tmp_path / "port"
        t = threading.Thread(target=main, args=(
            ["deploy", *ej, "--port", "0", "--port-file", str(port_file)],),
            kwargs=dict(storage=st, device="cpu"), daemon=True)
        t.start()
        for _ in range(600):
            if port_file.exists() and port_file.read_text().endswith("\n"):
                break
            time.sleep(0.05)
        p = int(port_file.read_text())
        req = urllib.request.Request(
            f"http://127.0.0.1:{p}/queries.json",
            data=json.dumps({"day": "Mon"}).encode(),
            headers={"Content-Type": "application/json"})
        reply = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert reply == {"temperature": pytest.approx((75 + 62) / 2)}
        assert main(["undeploy", "--port", str(p)], storage=st) == 0
        t.join(timeout=30)
        assert not t.is_alive()
    st.close()
