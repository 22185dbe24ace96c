"""The port's examples that compute on the device against the
reference's ``engine.py`` beside each, on the same data files and
queries, on the host: the four whose predict takes a top-k on the device
(``custom-datasource``, ``entitymap``, ``movielens-filtering``,
``similarproduct-multi``), the four that compute in torch where the
reference computes in XLA (``dimsum``, ``simrank``, ``regression``,
``stock``) and ``parallel-regression`` on the port's mesh of shards.

Tolerances: ALS trains start from the JAX trainer's initial factors;
each half's factors within 1e-4 of their scale, the training RMSE within
1e-5 relative, served top-K scores within 1e-4 of their scale with
equal ids outside ties (``torch_examples_common``).  dimsum's and
simrank's similarities within 1e-5 of their scale (f32 products in
another order), dimsum's neighbour ids equal outside ties; the
least-squares and momentum coefficients within 1e-5 of their scale
(1e-4 for the normal equations of ``parallel-regression``, whose f32
Gram sums run in another order on each mesh).  Every assertion that
``tests/test_examples.py`` makes of an example holds on the port's
answers too.
"""

import numpy as np
import pytest

from torch_examples_common import (
    contexts,
    example,
    one_torch_thread,
    rel_err,
    same_als,
    same_ranking,
    start_from_jax,
    train_both,
)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture()
def same_start(monkeypatch):
    start_from_jax(monkeypatch)


def _algo(engine, ep, k: int = 0):
    return engine._algorithms(ep)[k]


def _pairs(scores) -> list:
    return [(s.item, s.score) for s in scores]


def test_custom_datasource(same_start):
    with example("custom-datasource") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        td = pe._data_source(pep).read_training(contexts()[1])
        same_als((pm[0].factors.user_factors, pm[0].factors.item_factors),
                 (jm[0].factors.user_factors, jm[0].factors.item_factors),
                 (td.u, td.i, td.v))
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        for user in list(td.users.ids) + ["ghost"]:
            same_ranking(
                _pairs(algo.predict(pm[0], port.Query(user=user, num=3))),
                _pairs(jalgo.predict(jm[0], ref.Query(user=user, num=3))))
        res = algo.predict(pm[0], port.Query(user="u0", num=3))
        assert res and int(res[0].item[1:]) % 2 == 0
        assert algo.predict(pm[0], port.Query(user="ghost", num=3)) == []


def test_entitymap(same_start):
    with example("entitymap") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        model, jmodel = pm[0], jm[0]
        r = pe._data_source(pep).read_training(contexts()[1]).ratings
        same_als((model.user_factors, model.item_factors),
                 (jmodel.user_factors, jmodel.item_factors),
                 (r.user_ix, r.item_ix, r.rating))
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        for user in [f"u{k}" for k in range(7)] + ["nobody"]:
            same_ranking(
                _pairs(algo.predict(model, port.Query(user=user, num=3))),
                _pairs(jalgo.predict(jmodel, ref.Query(user=user, num=3))))
        assert "u6" not in model.users and len(model.users) == 6
        assert "i5" not in model.items and len(model.items) == 5
        assert model.users["u2"] == port.User(attr0=3.5, attr1=2, attr2=12)
        assert model.items["i1"].attrA == "green"
        assert isinstance(model.items["i0"].attrC, bool)
        res = algo.predict(model, port.Query(user="u0", num=3))
        assert len(res) == 3
        assert all(isinstance(s.payload, port.Item) for s in res)
        scores = [s.score for s in res]
        assert scores == sorted(scores, reverse=True)
        assert algo.predict(model, port.Query(user="nobody")) == []


def test_movielens_filtering(same_start, tmp_path):
    with example("movielens-filtering") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        r = pe._data_source(pep).read_training(contexts()[1])
        same_als((pm[0].user_factors, pm[0].item_factors),
                 (jm[0].user_factors, jm[0].item_factors),
                 (r.user_ix, r.item_ix, r.rating))
        from predictionio_tpu.controller.base import instantiate as jinst
        from predictionio_tpu_torch.controller import instantiate

        # serve against a scratch copy of the blocklist, which the test
        # edits
        blocked = tmp_path / "blocked.txt"
        blocked.write_text(open("blocked.txt").read())
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        serving = instantiate(port.BlocklistServing,
                              port.FilterParams(filepath=str(blocked)))
        jserving = jinst(ref.BlocklistServing,
                         ref.FilterParams(filepath=str(blocked)))

        def recommend(mod, a, model, s, user, num=4):
            q = mod.Query(user=user, num=num)
            return _pairs(s.serve(q, [a.predict(model, q)]).item_scores)

        for user in list(r.users.ids) + ["nobody"]:
            same_ranking(recommend(port, algo, pm[0], serving, user),
                         recommend(ref, jalgo, jm[0], jserving, user))
        items = [i for i, _ in recommend(port, algo, pm[0], serving, "u0")]
        assert len(items) == 4
        assert "m0" not in items and "m7" not in items
        # the blocklist is read per request
        blocked.write_text("")
        assert "m0" in [i for i, _ in recommend(port, algo, pm[0], serving,
                                                "u0", num=10)]


def test_similarproduct_multi(same_start):
    with example("similarproduct-multi") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        algos, jalgos = pe._algorithms(pep), je._algorithms(jep)
        assert len(algos) == 2 and len(pm) == 2
        # each model keeps the item half alone: within 1e-4 of its scale
        for m, jmod in zip(pm, jm):
            assert rel_err(m.item_factors, jmod.item_factors) <= 1e-4
        serving, jserving = pe._serving(pep), je._serving(jep)

        def serve(items, num):
            q = port.Query(items=items, num=num)
            return serving.serve(q, [a.predict(m, q)
                                     for a, m in zip(algos, pm)])

        for items, num in ((("phone",), 3), (("phone",), 1),
                           (("laptop", "rake"), 4), (("nothere",), 3)):
            q = port.Query(items=items, num=num)
            preds = [a.predict(m, q) for a, m in zip(algos, pm)]
            for p, ja, jmod in zip(preds, jalgos, jm):
                same_ranking(_pairs(p.item_scores), _pairs(ja.predict(
                    jmod, ref.Query(items=items, num=num)).item_scores))
            # the z-score blend magnifies the scores' last digits, so the
            # two servings are held on the same (the port's) predictions
            same_ranking(_pairs(serving.serve(q, preds).item_scores),
                         _pairs(jserving.serve(q, preds).item_scores),
                         tol=1e-9)
        r = serve(("phone",), 3)
        got = [s.item for s in r.item_scores]
        assert len(got) == 3 and "phone" not in got
        assert got[0] in {"laptop", "tablet", "camera"}, got
        assert all(abs(s.score) < 10 for s in r.item_scores)
        assert len(serve(("phone",), 1).item_scores) == 1


def test_dimsum():
    with example("dimsum") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        model, jmodel = pm[0], jm[0]
        assert rel_err(model.top_scores, jmodel.top_scores) <= 1e-5
        for row in range(len(model.items)):
            same_ranking(list(zip(model.top_items[row].tolist(),
                                  model.top_scores[row].tolist())),
                         list(zip(jmodel.top_items[row].tolist(),
                                  jmodel.top_scores[row].tolist())),
                         tol=1e-5)
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        for items in (("i1",), ("i3",), ("i1", "i4"), ("nope",)):
            same_ranking(
                _pairs(algo.predict(model, port.Query(items=items, num=2))),
                _pairs(jalgo.predict(jmodel, ref.Query(items=items, num=2))),
                tol=1e-5)
        res = algo.predict(model, port.Query(items=("i1",), num=2))
        assert res and res[0].item == "i2"
        res34 = algo.predict(model, port.Query(items=("i3",), num=2))
        assert res34 and res34[0].item == "i4"
        assert all(r.item != "i1" for r in res)


def test_simrank():
    from predictionio_tpu.controller import WorkflowContext as JaxContext
    from predictionio_tpu_torch.controller import WorkflowContext

    with example("simrank") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        model, jmodel = pm[0], jm[0]
        assert list(model.vertices.ids) == list(jmodel.vertices.ids)
        assert rel_err(model.scores, jmodel.scores) <= 1e-5
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        for user in list(model.vertices.ids) + ["nope"]:
            same_ranking(
                [(f.user, f.score)
                 for f in algo.predict(model, port.Query(user=user, num=3))],
                [(f.user, f.score)
                 for f in jalgo.predict(jmodel, ref.Query(user=user, num=3))],
                tol=1e-5)
        S = model.scores
        assert np.allclose(np.diag(S), 1.0)
        assert np.allclose(S, S.T, atol=1e-5)
        res = algo.predict(model, port.Query(user="0", num=3))
        assert res and res[0].user == "4"
        res4 = algo.predict(model, port.Query(user="4", num=3))
        assert res4 and res4[0].user == "0"
        assert algo.predict(model, port.Query(user="nope", num=3)) == []
        # the sampling data sources: the same sub-graphs (numpy draws)
        for name in ("node", "forestfire"):
            v = {"datasource": {"name": name, "params": {
                    "graph_edgelist_path": "edge_list_small.txt",
                    "sample_fraction": 0.6}},
                 "algorithms": [{"name": "simrank",
                                 "params": {"num_iterations": 3}}]}
            sub = pe.train(WorkflowContext(device="cpu",
                                           storage=contexts()[1].storage),
                           pe.params_from_variant(v))[0]
            jsub = je.train(JaxContext(storage=contexts()[0].storage),
                            je.params_from_variant(v))[0]
            assert list(sub.vertices.ids) == list(jsub.vertices.ids)
            assert rel_err(sub.scores, jsub.scores) <= 1e-5
            assert 2 <= len(sub.vertices) < 10
            assert np.allclose(np.diag(sub.scores), 1.0)


def test_regression():
    with example("regression") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        assert rel_err(pm[0], jm[0]) <= 1e-5
        algo = _algo(pe, pep)
        for feats in ([2.0, 3.0], [0.0, 0.0], [-1.5, 4.0]):
            got = pe._serving(pep).serve(None, [
                algo.predict(pm[0], port.Query(features=feats))])
            want = je._serving(jep).serve(None, [
                _algo(je, jep).predict(jm[0], ref.Query(features=feats))])
            assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
        assert algo.predict(pm[0], port.Query(features=[2.0, 3.0])) == (
            pytest.approx(6.0, abs=0.05))
        # a rank-deficient design (a repeated column) gets the
        # reference's minimum-norm answer, not a QR solve's
        x = np.concatenate([port.RegressionDataSource().read_training(
            None).x, np.zeros((10, 1), np.float32)], axis=1)
        x[:, 3] = x[:, 1]
        y = x[:, 1] + x[:, 2] + 1.0
        import jax.numpy as jnp
        import torch

        want = np.asarray(jnp.linalg.lstsq(jnp.asarray(x), jnp.asarray(y))[0])
        got = port.lstsq_svd(torch.as_tensor(x), torch.as_tensor(y)).numpy()
        assert rel_err(got, want) <= 1e-5


def test_stock():
    with example("stock") as (ref, port):
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port)
        assert rel_err(pm[0].slopes, jm[0].slopes) <= 1e-5
        algo, jalgo = _algo(pe, pep), _algo(je, jep)
        for t in ("UPCO", "DNCO", "FLAT", "NOPE"):
            got = algo.predict(pm[0], port.Query(ticker=t))
            want = jalgo.predict(jm[0], ref.Query(ticker=t))
            assert got.signal == want.signal
            assert got.expected_return == pytest.approx(
                want.expected_return,
                abs=1e-5 * np.abs(jm[0].slopes).max())
        assert algo.predict(pm[0], port.Query(ticker="UPCO")).signal == "long"
        assert algo.predict(pm[0], port.Query(ticker="DNCO")).signal == (
            "short")
        assert algo.predict(pm[0], port.Query(ticker="FLAT")).signal == "flat"
        assert algo.predict(pm[0], port.Query(ticker="NOPE")).signal == "flat"


@pytest.mark.parametrize("shards", [1, 4])
def test_parallel_regression(shards):
    """The port's moments on a mesh of 1 and of 4 host shards (64 rows:
    padded to the mesh) against the reference on conftest's 8 virtual
    devices."""
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.parallel import make_mesh

    with example("parallel-regression") as (ref, port):
        ctx = WorkflowContext(device="cpu", storage=contexts()[1].storage,
                              mesh=make_mesh(devices=["cpu"] * shards))
        (je, jep, jm), (pe, pep, pm) = train_both(ref, port, port_ctx=ctx)
        w = pm[0]
        assert rel_err(w, jm[0]) <= 1e-4
        algo = _algo(pe, pep)
        pred = algo.predict(w, port.Query(features=[1.0, 2.0]))
        assert pred == pytest.approx(
            _algo(je, jep).predict(jm[0], ref.Query(features=[1.0, 2.0])),
            rel=1e-4)
        assert pred == pytest.approx(1 + 2 * 1.0 - 0.5 * 2.0, abs=0.05)
        assert w[0] == pytest.approx(1.0, abs=0.05)
        assert w[1] == pytest.approx(2.0, abs=0.05)
        assert w[2] == pytest.approx(-0.5, abs=0.05)
