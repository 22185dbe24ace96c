"""The recommendation template's evaluation against the JAX package's,
on one small SQLite store that both packages read (40 users x 30 items x
600 rate events, half stars, made from a numpy seed).

``read_eval``'s folds must equal the reference's bit for bit (ids,
ratings, order); ``RMSEMetric`` on one JAX model carried across with
``convert.model_from_jax`` must agree within 1e-9; a whole
``run_evaluation`` over two candidates, both packages starting every
fold from the JAX trainer's initial factors, must give each candidate's
RMSE within 1e-5 relative and the same best index, for both kernel
solvers (their plain versions here; the JAX Pallas kernels in interpret
mode).  The console's ``eval`` prints the reference's lines, writes
``best.json`` and a completed record.
"""

import json
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.cli.main import main as jax_main
from predictionio_tpu.controller import WorkflowContext as JaxContext
from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch import engines
from predictionio_tpu_torch.cli.main import _REFUSED, main
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine
from predictionio_tpu_torch.convert import factors_from_jax, model_from_jax
from predictionio_tpu_torch.engines import spec as spec_mod
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.bimap import StringIndex
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.workflow import run_evaluation

N_USERS, N_ITEMS, PER_USER = 40, 30, 15
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """The shared store: 600 distinct (user, item) rate events of app
    "shop" and a category ``$set`` for every item, written by the port."""
    path = tmp_path_factory.mktemp("evalhome")
    st = Storage({"PIO_TPU_HOME": str(path)})
    app = st.get_metadata().app_insert("shop")
    es = st.get_event_store()
    es.init_channel(app.id)
    rng = np.random.default_rng(7)
    events = [
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": float(rng.integers(2, 11)) / 2})
        for u in range(N_USERS)
        for i in rng.choice(N_ITEMS, size=PER_USER, replace=False).tolist()
    ]
    events += [
        Event(event="$set", entity_type="item", entity_id=f"i{j}",
              properties={"categories": ["even" if j % 2 == 0 else "odd"]})
        for j in range(N_ITEMS)
    ]
    es.insert_batch(events, app.id)
    st.close()
    return path


@pytest.fixture()
def stores(home):
    st = {"torch": Storage({"PIO_TPU_HOME": str(home)}),
          "jax": JaxStorage({"PIO_TPU_HOME": str(home)})}
    yield st
    for s in st.values():
        s.close()


def _variant(lam, solver="fused", k=3, seed=3):
    return {"datasource": {"params": {"appName": "shop", "evalK": k,
                                      "evalSeed": seed}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": 2, "lambda": lam,
                "solver": solver}}]}


def _folds(kind, stores, k, seed):
    mod = rec if kind == "torch" else jrec
    ctx = (WorkflowContext(device="cpu", storage=stores["torch"])
           if kind == "torch" else JaxContext(storage=stores["jax"]))
    engine = mod.recommendation_evaluation().engine
    ds = engine._data_source(engine.params_from_variant(
        _variant(0.1, k=k, seed=seed)))
    return ds.read_eval(ctx), ctx


@pytest.mark.parametrize("k,seed", [(3, 3), (4, 11)])
def test_folds_equal_the_reference_bit_for_bit(stores, k, seed):
    port, _ = _folds("torch", stores, k, seed)
    ref, _ = _folds("jax", stores, k, seed)
    assert len(port) == len(ref) == k
    held = []
    for (ptd, pei, pqa), (rtd, rei, rqa) in zip(port, ref):
        assert pei == rei
        for name in ("user_ix", "item_ix", "rating"):
            a, b = getattr(ptd.ratings, name), getattr(rtd.ratings, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert list(ptd.ratings.users.ids) == list(rtd.ratings.users.ids)
        assert list(ptd.ratings.items.ids) == list(rtd.ratings.items.ids)
        assert ptd.items == rtd.items
        assert [(q.user, q.num, type(a.rating), a.item, a.rating)
                for q, a in pqa] == [
            (q.user, q.num, type(a.rating), a.item, a.rating)
            for q, a in rqa]
        held.append(len(pqa))
    # every rating is held out exactly once, the folds balanced
    assert sum(held) == N_USERS * PER_USER
    assert max(held) - min(held) <= 1


def test_rmse_metric_on_a_carried_model_agrees(stores):
    ref, jctx = _folds("jax", stores, 3, 3)
    port, _ = _folds("torch", stores, 3, 3)
    algo = jrec.recommendation_evaluation().engine._algorithms(
        jrec.recommendation_evaluation().engine.params_from_variant(
            _variant(0.1)))[0]
    jmodel = algo.train(jctx, ref[0][0])
    pmodel = model_from_jax(jmodel, "cpu")
    got = {}
    for kind, mod, model, folds in (("jax", jrec, jmodel, ref),
                                    ("torch", rec, pmodel, port)):
        data = [(ei, [(q, mod.RatingPrediction(model=model, user=q.user), a)
                      for q, a in qa]) for _, ei, qa in folds]
        got[kind] = mod.RMSEMetric().calculate(None, data)
    assert np.isfinite(got["torch"])
    assert abs(got["torch"] - got["jax"]) <= 1e-9 * got["jax"]
    assert rec.RMSEMetric().compare(1.0, 2.0) == 1
    assert rec.RMSEMetric().compare(2.0, 1.0) == -1


def _pair(q, a) -> tuple:
    return (q.user, q.num, q.categories, q.whitelist, q.blacklist,
            a.item, a.rating, type(a.rating))


def test_columnar_held_out_pairs_are_the_references(stores):
    """Each fold's held-out pairs are carried as columns: iterating,
    indexing and ``len`` give the reference's (Query, ActualRating)
    list, the engine serves them as columns (the triples the generic
    path builds, in order), and RMSE over them is the reference's."""
    ref, jctx = _folds("jax", stores, 3, 3)
    port, _ = _folds("torch", stores, 3, 3)
    engine = rec.recommendation_evaluation().engine
    algo = engine._algorithms(engine.params_from_variant(_variant(0.1)))[0]
    jalgo = jrec.recommendation_evaluation().engine._algorithms(
        jrec.recommendation_evaluation().engine.params_from_variant(
            _variant(0.1)))[0]
    jmodel = jalgo.train(jctx, ref[0][0])
    model = model_from_jax(jmodel, "cpu")
    model.users, model.items = port[0][0].ratings.users, \
        port[0][0].ratings.items
    serving = rec.RecommendationServing()
    data, ref_data = [], []
    for (_, ei, qa), (_, _, rqa) in zip(port, ref):
        assert isinstance(qa, rec.HeldOutRatings)
        assert len(qa) == len(rqa)
        assert [_pair(*x) for x in qa] == [_pair(*x) for x in rqa]
        assert [_pair(*qa[j]) for j in (0, len(qa) - 1, -1)] == [
            _pair(*rqa[j]) for j in (0, -1, -1)]
        assert [_pair(*x) for x in qa[2:9:3]] == [
            _pair(*x) for x in rqa[2:9:3]]
        with pytest.raises(IndexError):
            qa[len(qa)]
        served = FastEvalEngine._batch_serve([algo], [model], serving, qa)
        assert isinstance(served, rec.ServedRatings)
        generic = rec.Engine._batch_serve([algo], [model], serving, qa)
        assert isinstance(generic, list)
        assert len(served) == len(generic)
        assert [(q, p.user, p.model is model, a) for q, p, a in served] == [
            (q, p.user, p.model is model, a) for q, p, a in generic]
        data.append((ei, served))
        ref_data.append((ei, [(q, jrec.RatingPrediction(model=jmodel,
                                                        user=q.user), a)
                              for q, a in rqa]))
    got = rec.RMSEMetric().calculate(None, data)
    want = jrec.RMSEMetric().calculate(None, ref_data)
    assert np.isfinite(got) and abs(got - want) <= 1e-6 * want
    # a model with its own id index reads the same ratings
    model.users = StringIndex(list(model.users.ids)[::-1])
    model.user_factors = model.user_factors[::-1].copy()
    assert abs(rec.RMSEMetric().calculate(None, data) - want) <= 1e-6 * want


@pytest.fixture()
def same_start(monkeypatch):
    """The port's trainer starts from the JAX trainer's initial factors
    (every fold has the same shapes, so one pair serves all)."""
    v = np.ones(1, np.float32)
    jt = JaxALSTrainer((np.zeros(1, np.int32), np.zeros(1, np.int32), v),
                       N_USERS, N_ITEMS, JaxALSConfig(rank=RANK, seed=3))
    U0, V0 = (np.asarray(a) for a in jt.init_factors())
    monkeypatch.setattr(port_als.ALSTrainer, "init_factors",
                        lambda self: factors_from_jax(U0, V0, self.device))


@pytest.mark.parametrize("solver", ["fused", "pallas"])
def test_run_evaluation_matches_the_reference(stores, same_start, solver,
                                              tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lams = (0.01, 0.3)
    results = {}
    for kind, mod, run, ctx in (
            ("jax", jrec, jax_run_evaluation,
             JaxContext(storage=stores["jax"], mode="Evaluation")),
            ("torch", rec, run_evaluation,
             WorkflowContext(device="cpu", storage=stores["torch"],
                             mode="Evaluation"))):
        evaluation = mod.recommendation_evaluation()
        eps = [evaluation.engine.params_from_variant(_variant(lam, solver))
               for lam in lams]
        eid, result = run(evaluation, eps, ctx=ctx)
        results[kind] = result
        rec_ = stores[kind].get_metadata().evaluation_instance_get(eid)
        assert rec_.status == "EVALCOMPLETED"
    port, ref = results["torch"], results["jax"]
    assert port.best_index == ref.best_index
    for (_, p, _), (_, r, _) in zip(port.results, ref.results):
        assert np.isfinite(p) and abs(p - r) <= 1e-5 * r, (p, r)
    assert port.best_score == min(s for _, s, _ in port.results)
    assert port.metric_header == ref.metric_header == "RMSE"


def test_parallel_sweep_equals_the_sequential_one(stores, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    ctx = WorkflowContext(device="cpu", storage=stores["torch"],
                          mode="Evaluation")
    evaluation = rec.recommendation_evaluation()
    eps = [evaluation.engine.params_from_variant(_variant(lam))
           for lam in (0.05, 0.2, 0.8)]
    _, seq = run_evaluation(evaluation, eps, ctx=ctx)
    _, par = run_evaluation(evaluation, eps, ctx=ctx, parallelism=3)
    assert [s for _, s, _ in par.results] == [s for _, s, _ in seq.results]
    assert par.best_index == seq.best_index


GEN = '''
from {pkg}.templates.recommendation import recommendation_evaluation
engine = recommendation_evaluation().engine
class Gen:
    engine_params_list = [engine.params_from_variant(v) for v in {variants}]
'''


def test_console_eval_prints_the_reference_lines(stores, same_start,
                                                 tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    variants = [_variant(lam) for lam in (0.01, 0.3)]
    for kind, pkg in (("jax", "predictionio_tpu"),
                      ("torch", "predictionio_tpu_torch")):
        (tmp_path / f"gen_{kind}.py").write_text(
            GEN.format(pkg=pkg, variants=variants))
    monkeypatch.syspath_prepend(str(tmp_path))
    # the reference names the evaluation by its dotted path (its
    # `--engine NAME GEN` reads GEN as the evaluation's slot)
    rc = jax_main(["eval", "predictionio_tpu.templates.recommendation."
                   "recommendation_evaluation", "gen_jax.Gen"],
                  storage=stores["jax"])
    ref = capsys.readouterr().out.splitlines()
    assert rc == 0
    ref_best = json.loads((tmp_path / "best.json").read_text())
    rc = main(["eval", "--engine", "recommendation", "gen_torch.Gen"],
              storage=stores["torch"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(out) == len(ref) == 2
    score = float(re.fullmatch(r"\[(.+)\] RMSE", out[0]).group(1))
    ref_score = float(re.fullmatch(r"\[(.+)\] RMSE", ref[0]).group(1))
    assert abs(score - ref_score) <= 1e-5 * ref_score
    eid = re.fullmatch(r"Evaluation completed\. Instance id: ([0-9a-f]{16})",
                       out[1]).group(1)
    assert re.fullmatch(r"Evaluation completed\. Instance id: [0-9a-f]{16}",
                        ref[1])
    r = stores["torch"].get_metadata().evaluation_instance_get(eid)
    assert (r.status, r.evaluator_results, r.engine_params_generator_class,
            r.evaluation_class) == (
        "EVALCOMPLETED", out[0], "gen_torch.Gen",
        "predictionio_tpu_torch.templates.recommendation."
        "recommendation_evaluation")
    # best.json names the winner, and reads back into its params
    best = json.loads((tmp_path / "best.json").read_text())
    assert best["algorithms"] == ref_best["algorithms"]
    engine = rec.recommendation_evaluation().engine
    winner = engine.params_from_variant(variants[json.loads(
        r.evaluator_results_json)["bestIndex"]])
    back = engine.params_from_variant(best)
    assert (back.algorithms, back.data_source) == (
        winner.algorithms, winner.data_source)
    # no candidate list: the reference's message, exit code 1
    with pytest.raises(ValueError) as no_list:
        jax_main(["eval", "--engine", "recommendation"],
                 storage=stores["jax"])
    capsys.readouterr()
    assert main(["eval", "--engine", "recommendation"],
                storage=stores["torch"], device="cpu") == 1
    assert capsys.readouterr().out == f"Error: {no_list.value}\n"
    # the console's own process takes the card, which this host lacks
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["eval", "--engine", "recommendation", "gen_torch.Gen"],
                 storage=stores["torch"])


def test_eval_is_no_longer_refused(stores, capsys):
    # the command itself is ported; only its observability options wait
    assert ("eval", None) not in {(cmd, dest) for cmd, dest, *_ in _REFUSED}
    rc = main(["eval"], storage=stores["torch"], device="cpu")
    port = capsys.readouterr().out
    assert (rc, port) == (jax_main(["eval"], storage=stores["jax"]),
                          capsys.readouterr().out)
    assert port == "Error: pass an evaluation dotted path or --engine NAME.\n"


def test_engine_specs_describe_their_evaluation(stores, monkeypatch, capsys):
    desc = engines.get_engine_spec("recommendation").describe()
    assert desc["evaluation"] == (
        "predictionio_tpu_torch.templates.recommendation."
        "recommendation_evaluation")
    # a spec that declares no evaluation reports null and is refused by
    # `eval --engine`, with the reference's message
    from predictionio_tpu.engines import spec as jax_spec_mod

    for mod in (spec_mod, jax_spec_mod):
        monkeypatch.setitem(mod._registry, "noeval", mod.EngineSpec(
            name="noeval", description="", factory=rec.recommendation_engine,
            factory_path="x.noeval"))
    assert engines.get_engine_spec("noeval").describe()["evaluation"] is None
    outs = []
    for run, st in ((jax_main, stores["jax"]), (main, stores["torch"])):
        kw = {} if run is jax_main else {"device": "cpu"}
        assert run(["eval", "--engine", "noeval"], storage=st, **kw) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == (
        "Error: engine 'noeval' declares no evaluation; pass a dotted "
        "evaluation path instead.\n")
