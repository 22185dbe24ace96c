"""The port's evaluation layer against the JAX package's: the metric
family, ``MetricEvaluator`` (argmax, lower-is-better ordering, NaN,
renderings, the parallel sweep), FastEval's prefix cache,
``run_evaluation`` and ``run_fake`` with their records, which each
package reads from the other's ``metadata.db``.

A deterministic toy engine is written once per package (the same code
over each package's controller classes) and fed the same inputs, made
from numpy seeds; host NumPy on both sides, so values compare exactly.
"""

import importlib
import json
import math
from dataclasses import dataclass, fields

import numpy as np
import pytest

PKGS = {"jax": "predictionio_tpu", "torch": "predictionio_tpu_torch"}


def _mod(kind, name):
    return importlib.import_module(f"{PKGS[kind]}.{name}")


def _ctx(kind, storage=None):
    c = _mod(kind, "controller")
    if kind == "torch":
        return c.WorkflowContext(device="cpu", storage=storage,
                                 mode="Evaluation")
    return c.WorkflowContext(storage=storage, mode="Evaluation")


def _storage(kind, home):
    return _mod(kind, "storage").Storage({"PIO_TPU_HOME": str(home)})


def toy(kind):
    """(engine, params class, id metric) over ``kind``'s controller: a
    candidate's model is its algorithm id, every prediction is the pair
    (model, query), and the metric reads the model back (NaN for a
    negative id), so a sweep's winner is known in advance."""
    c = _mod(kind, "controller")

    @dataclass(frozen=True)
    class ToyParams(c.Params):
        id: int = 0
        fail: bool = False

    class ToySource(c.DataSource):
        params_class = ToyParams

        def read_training(self, ctx):
            return self.params.id

        def read_eval(self, ctx):
            rng = np.random.default_rng(self.params.id)
            return [(self.params.id, {"set": s},
                     [(float(q), float(a)) for q, a in
                      rng.normal(size=(4, 2))]) for s in range(2)]

    class ToyAlgo(c.Algorithm):
        params_class = ToyParams

        def train(self, ctx, pd):
            if self.params.fail:
                raise RuntimeError("toy algorithm failed")
            return float(self.params.id)

        def predict(self, model, query):
            return (model, query)

    class ToyServing(c.Serving):
        def serve(self, query, predictions):
            return predictions[0]

    class IdMetric(c.Metric):
        def calculate(self, ctx, data):
            model = data[0][1][0][1][0]
            return model if model >= 0 else float("nan")

    engine = c.Engine(ToySource, c.IdentityPreparator, {"a": ToyAlgo},
                      ToyServing)
    return engine, ToyParams, IdMetric


def _ep(kind, P, algo_id, ds_id=1, fail=False):
    return _mod(kind, "controller").EngineParams(
        data_source=("", P(id=ds_id)),
        algorithms=[("a", P(id=algo_id, fail=fail))],
    )


def _candidates(kind, ids):
    engine, P, M = toy(kind)
    return engine, [_ep(kind, P, i) for i in ids], M


# -- the metric family --------------------------------------------------------

METRICS = ("AverageMetric", "OptionAverageMetric", "StdevMetric",
           "OptionStdevMetric", "SumMetric", "ZeroMetric", "MAPatK")


def _point_data(seed=0):
    """Two eval sets of (query, prediction, actual) floats; a negative
    query has no point in the Option variants."""
    rng = np.random.default_rng(seed)
    return [(s, [tuple(map(float, row)) for row in rng.normal(size=(6, 3))])
            for s in range(2)]


def _ranking_data(m, seed=0):
    rng = np.random.default_rng(seed)
    data = []
    for s in range(2):
        qpa = []
        for _ in range(5):
            ranked = rng.permutation(8)[:5]
            rel = rng.choice(8, size=int(rng.integers(0, 4)), replace=False)
            qpa.append((None,
                        {"itemScores": [{"item": f"i{j}"} for j in ranked]},
                        m.ActualItems(items=tuple(f"i{j}" for j in rel))))
        data.append((s, qpa))
    return data


def _metric(m, name):
    if name == "MAPatK":
        return m.MAPatK(k=3)
    base = getattr(m, name)
    optional = name.startswith("Option") or name == "SumMetric"

    def point(self, q, p, a):
        if optional and q < 0:
            return None
        return (p - a) ** 2 + q

    return type(name, (base,), {"calculate_point": point})()


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_gives_the_reference_value(name):
    got = {}
    for kind in PKGS:
        m = _mod(kind, "controller.metrics")
        metric = _metric(m, name)
        data = _ranking_data(m) if name == "MAPatK" else _point_data()
        got[kind] = (metric.header, str(metric),
                     metric.calculate(None, data),
                     metric.compare(1.0, 2.0), metric.compare(2.0, 2.0))
        if name in ("AverageMetric", "StdevMetric"):
            # the strict variants refuse a point without a value
            holey = [(0, [(-1.0, 0.0, 0.0)])]
            none = type("Holey", (metric.__class__,),
                        {"calculate_point": lambda self, q, p, a: None})()
            with pytest.raises(ValueError, match="Option"):
                none.calculate(None, holey)
    assert got["torch"] == got["jax"]
    assert not math.isnan(got["torch"][2])


# -- MetricEvaluator -----------------------------------------------------------


def test_metric_evaluator_argmax_ordering_nan_and_empty():
    for kind in PKGS:
        ev = _mod(kind, "controller.evaluation")
        ctx = _ctx(kind)
        sweeps = {}
        for ids in ((3, 9, 5), (-1, 2, -1), (-1, -2), (4,)):
            engine, eps, M = _candidates(kind, ids)
            r = ev.MetricEvaluator(M(), output_path=None).evaluate(
                ctx, engine, eps)
            sweeps[ids] = (r.best_index, r.best_score)
            assert r.best_engine_params == eps[r.best_index]

            class Loss(M):
                def compare(self, a, b):
                    return -super().compare(a, b)

            lo = ev.MetricEvaluator(Loss(), output_path=None).evaluate(
                ctx, engine, eps)
            sweeps[ids, "loss"] = (lo.best_index, lo.best_score)
        assert sweeps[(3, 9, 5)] == (1, 9.0)
        assert sweeps[(3, 9, 5), "loss"] == (0, 3.0)
        # a NaN never beats a finite score, whichever order
        assert sweeps[(-1, 2, -1)] == (1, 2.0)
        assert sweeps[(-1, 2, -1), "loss"] == (1, 2.0)
        assert sweeps[(-1, -2)][0] == 0 and math.isnan(sweeps[(-1, -2)][1])
        assert sweeps[(4,)] == (0, 4.0)
        engine, _, M = _candidates(kind, ())
        with pytest.raises(ValueError, match="must not be empty"):
            ev.MetricEvaluator(M(), output_path=None).evaluate(
                ctx, engine, [])


def test_result_renderings_and_best_json_equal_the_reference(tmp_path):
    out = {}
    for kind in PKGS:
        ev = _mod(kind, "controller.evaluation")
        engine, eps, M = _candidates(kind, (2, 7, 5))

        class Other(M):
            header = "Other"

            def calculate(self, ctx, data):
                return len(data)

        path = tmp_path / f"best-{kind}.json"
        r = ev.MetricEvaluator(M(), [Other()], output_path=str(path)).evaluate(
            _ctx(kind), engine, eps)
        out[kind] = (r.to_one_liner(), r.to_json(), r.to_html(),
                     path.read_text())
    assert out["torch"] == out["jax"]
    one, js, html, best = out["torch"]
    assert one == "[7.0] IdMetric"
    assert json.loads(js)["bestIndex"] == 1
    assert "<h3>Best score: 7.0 (IdMetric)</h3>" in html
    doc = json.loads(best)
    assert doc["id"] == "best"
    assert doc["algorithms"] == [{"name": "a",
                                  "params": {"id": 7, "fail": False}}]


# -- FastEval -----------------------------------------------------------------


def _fast_eval_stats(kind):
    """The reference's FastEval cases (tests/test_evaluation.py): shared
    prefixes, a distinct data source, a full hit, and params without
    value equality, each as the cache's hit counts."""
    fe = _mod(kind, "controller.fast_eval")
    engine, P, _ = toy(kind)
    ctx = _ctx(kind)
    stats = []
    e = fe.FastEvalEngine(engine)
    for i in (1, 2, 3):
        e.eval(ctx, _ep(kind, P, i))
    stats.append(dict(e.stats))
    e = fe.FastEvalEngine(engine)
    e.eval(ctx, _ep(kind, P, 1))
    e.eval(ctx, _ep(kind, P, 1, ds_id=99))
    stats.append(dict(e.stats))
    e.clear_cache()
    e.eval(ctx, _ep(kind, P, 1))
    e.eval(ctx, _ep(kind, P, 1))
    stats.append(dict(e.stats))

    class Opaque:
        def __init__(self, id):
            self.id = id

    c = _mod(kind, "controller")
    a, b = (c.EngineParams(data_source=("", Opaque(1)),
                           algorithms=[("a", P(id=3))]) for _ in range(2))
    e = fe.FastEvalEngine(engine)
    e.eval(ctx, a)
    e.eval(ctx, b)
    e.eval(ctx, a)
    stats.append(dict(e.stats))
    plain = engine.eval(ctx, _ep(kind, P, 7))
    assert fe.FastEvalEngine(engine).eval(ctx, _ep(kind, P, 7)) == plain
    return stats, plain


def test_fast_eval_reuses_prefixes_as_the_reference():
    port, ref = _fast_eval_stats("torch"), _fast_eval_stats("jax")
    assert port == ref
    assert port[0] == [{"ds": 1, "prep": 1, "algo": 3},
                       {"ds": 2, "prep": 2, "algo": 2},
                       {"ds": 1, "prep": 1, "algo": 1},
                       {"ds": 2, "prep": 2, "algo": 2}]


# -- the workflow and its records ----------------------------------------------


def _record(rec) -> dict:
    return {f.name: getattr(rec, f.name) for f in fields(rec)}


def test_run_evaluation_lifecycle_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = {}
    for kind in PKGS:
        run_evaluation = _mod(kind, "workflow.evaluate").run_evaluation
        ev = _mod(kind, "controller.evaluation")
        st = _storage(kind, tmp_path / kind)
        md = st.get_metadata()
        engine, P, M = toy(kind)
        ctx = _ctx(kind, st)
        eid, result = run_evaluation(
            ev.Evaluation(engine, M()), [_ep(kind, P, i) for i in (3, 9)],
            ctx=ctx, evaluation_class="toy.Eval",
            engine_params_generator_class="toy.Gen")
        ok = md.evaluation_instance_get(eid)
        assert (ok.status, ok.evaluator_results, ok.evaluator_results_json,
                ok.evaluator_results_html) == (
            "EVALCOMPLETED", result.to_one_liner(), result.to_json(),
            result.to_html())
        assert ok.end_time and ok.start_time <= ok.end_time
        with pytest.raises(RuntimeError, match="toy algorithm failed"):
            run_evaluation(ev.Evaluation(engine, M()),
                           [_ep(kind, P, 4, fail=True)], ctx=ctx)
        (failed,) = [r for r in _all_evaluations(st) if r.id != eid]
        # no candidates: refused before any record is written
        with pytest.raises(ValueError) as no_cands:
            run_evaluation(ev.Evaluation(engine, M()), ctx=ctx)
        assert len(_all_evaluations(st)) == 2
        seen[kind] = (ok.status, ok.evaluation_class,
                      ok.engine_params_generator_class,
                      ok.evaluator_results, failed.status,
                      failed.evaluator_results, str(no_cands.value),
                      [r.id for r in md.evaluation_instance_get_completed()])
        st.close()
    port, ref = seen["torch"], seen["jax"]
    assert port[:-1] == ref[:-1]
    assert port[:6] == ("EVALCOMPLETED", "toy.Eval", "toy.Gen", "[9.0] IdMetric",
                        "EVALFAILED", "")
    assert len(port[-1]) == len(ref[-1]) == 1


def _all_evaluations(st):
    rows = st.get_metadata()._conn.execute(
        "SELECT id FROM evaluation_instances").fetchall()
    return [st.get_metadata().evaluation_instance_get(r[0]) for r in rows]


def test_records_cross_between_the_packages(tmp_path, monkeypatch):
    """Each package's run_evaluation and run_fake record, read by the
    other package's DAO from the same metadata.db, field for field."""
    monkeypatch.chdir(tmp_path)
    home = tmp_path / "home"
    written = {}
    for kind in PKGS:
        st = _storage(kind, home)
        wf = _mod(kind, "workflow")
        engine, P, M = toy(kind)
        ev = _mod(kind, "controller.evaluation")
        ctx = _ctx(kind, st)
        eid, _ = wf.run_evaluation(ev.Evaluation(engine, M()),
                                   [_ep(kind, P, 5)], ctx=ctx)
        fid = wf.run_fake(lambda ctx: None, ctx=ctx)
        with pytest.raises(KeyError):
            wf.FakeRun(lambda ctx: {}["missing"]).run(ctx)
        st.close()
        written[kind] = (eid, fid)
    for writer, reader in (("torch", "jax"), ("jax", "torch")):
        st_w, st_r = _storage(writer, home), _storage(reader, home)
        for rid in written[writer]:
            w = st_w.get_metadata().evaluation_instance_get(rid)
            r = st_r.get_metadata().evaluation_instance_get(rid)
            assert type(r).__module__.startswith(PKGS[reader] + ".")
            assert _record(r) == _record(w)
            assert r.status == "EVALCOMPLETED"
        st_w.close()
        st_r.close()
    st = _storage("torch", home)
    recs = _all_evaluations(st)
    assert sorted(r.status for r in recs) == ["EVALCOMPLETED"] * 4 + [
        "EVALFAILED"] * 2
    assert [r.evaluator_results for r in recs
            if r.batch == "FakeRun" and r.status == "EVALCOMPLETED"] == [
        "FakeRun completed"] * 2
    st.close()


def test_parallel_sweep_equals_the_sequential_one(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ev = _mod("torch", "controller.evaluation")
    fe = _mod("torch", "controller.fast_eval")
    engine, eps, M = _candidates("torch", (3, -1, 8, 6, 8, 1))
    ctx = _ctx("torch")
    seq = ev.MetricEvaluator(M(), output_path=None).evaluate(ctx, engine, eps)
    par = ev.MetricEvaluator(M(), output_path=None).evaluate(
        ctx, engine, eps, parallelism=3)
    assert par.to_json() == seq.to_json()
    assert (par.best_index, par.best_score) == (2, 8.0)
    for kind in PKGS:
        f_engine, f_eps, f_M = _candidates(kind, (1, 2))
        f_ev = _mod(kind, "controller.evaluation")
        with pytest.raises(ValueError, match="FastEvalEngine"):
            f_ev.MetricEvaluator(f_M(), output_path=None).evaluate(
                _ctx(kind), _mod(kind, "controller.fast_eval").FastEvalEngine(
                    f_engine), f_eps, parallelism=2)
    # run_evaluation unwraps a FastEval engine for a parallel sweep
    st = _storage("torch", tmp_path / "home")
    run_evaluation = _mod("torch", "workflow.evaluate").run_evaluation
    eid, r = run_evaluation(ev.Evaluation(fe.FastEvalEngine(engine), M()),
                            eps, ctx=_ctx("torch", st), parallelism=2)
    assert r.to_json() == seq.to_json()
    assert st.get_metadata().evaluation_instance_get(eid).status == (
        "EVALCOMPLETED")
    st.close()
