"""The port's classification engine and its three models against the JAX
package's, on the same seeded numpy data.

Tolerances: naive Bayes' log priors and likelihoods within 1e-6 (the
same f32 segment sums and logs, in another order); logistic weights
within 1e-4 of their scale after 300 Adam steps (the f32 sums of 300
full-batch gradients run in another order than XLA's), with the same
labels; the forest's host fit is the reference's numpy code with the
same generator stream, so its trees are bitwise equal, and its device
walk gives equal labels and votes.  The engine (data source with its
``required`` attributes, the three algorithms, persistence) answers as
the JAX engine does.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import WorkflowContext as JaxContext
from predictionio_tpu.models import forest as jforest
from predictionio_tpu.models.logistic import train_logistic as jax_logistic
from predictionio_tpu.models.naive_bayes import (
    train_naive_bayes as jax_naive_bayes,
)
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu.templates import classification as jcls
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import (
    forest_from_jax,
    logistic_from_jax,
    naive_bayes_from_jax,
)
from predictionio_tpu_torch.models import forest
from predictionio_tpu_torch.models.logistic import train_logistic
from predictionio_tpu_torch.models.naive_bayes import train_naive_bayes
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.templates import classification as cls
from predictionio_tpu_torch.workflow import prepare_deploy, run_train

CLASSES = ("a", "b", "c", "d")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mixture(n: int, seed: int = 0, spread: float = 1.0):
    """Non-negative features of a per-class mixture (multinomial naive
    Bayes applies), labels among :data:`CLASSES`."""
    rng = np.random.default_rng(seed)
    centers = np.array([[4.0, 1.0, 0.5], [1.0, 4.0, 0.5],
                        [0.5, 1.0, 4.0], [3.0, 3.0, 3.0]])
    y = rng.integers(0, len(CLASSES), size=n)
    x = np.abs(centers[y] + spread * rng.normal(size=(n, 3)))
    return x.astype(np.float32), np.asarray(CLASSES, dtype=object)[y]


def test_naive_bayes_matches_jax():
    x, y = mixture(500, seed=1)
    got = train_naive_bayes(x, y, lam=0.5, device="cpu")
    want = jax_naive_bayes(x, y, lam=0.5)
    np.testing.assert_allclose(got.log_prior, want.log_prior, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood,
                               rtol=0, atol=1e-6)
    assert list(got.labels) == list(want.labels)
    xt, _ = mixture(300, seed=2)
    assert list(got.predict(xt)) == list(want.predict(xt))
    # the JAX model served by the port's class
    carried = naive_bayes_from_jax(want)
    assert list(carried.predict(xt)) == list(want.predict(xt))


def test_logistic_matches_jax_after_300_steps():
    x, y = mixture(800, seed=3)
    got = train_logistic(x, y, device="cpu")
    want = jax_logistic(x, y)
    scale = float(np.abs(want.weights).max())
    assert np.abs(got.weights - want.weights).max() <= 1e-4 * scale
    assert np.abs(got.bias - want.bias).max() <= 1e-4 * max(
        scale, float(np.abs(want.bias).max()))
    xt, _ = mixture(2000, seed=4)
    assert (got.predict(xt) == want.predict(xt)).all()
    np.testing.assert_allclose(got.predict_proba(xt),
                               want.predict_proba(xt), atol=1e-4)
    carried = logistic_from_jax(want)
    assert (carried.predict(xt) == want.predict(xt)).all()


@pytest.mark.parametrize("subset,depth", [("sqrt", 6), ("all", 4),
                                          ("log2", 5)])
def test_forest_trees_bitwise_and_the_walk_equal(subset, depth):
    x, y = mixture(600, seed=5, spread=1.5)
    labels = np.searchsorted(CLASSES, y).astype(np.int32)
    kw = dict(n_trees=8, max_depth=depth, num_classes=4,
              feature_subset=subset, seed=7)
    got = forest.train_forest(x, labels, forest.ForestConfig(**kw))
    want = jforest.train_forest(x, labels, jforest.ForestConfig(**kw))
    for name in ("feature", "threshold", "label"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (got.num_classes, got.n_features, got.max_depth) == (
        want.num_classes, want.n_features, want.max_depth)
    assert (got.feature >= 0).any() and (got.feature == -1).any()
    xt, _ = mixture(333, seed=6, spread=1.5)
    gl, gv = forest.forest_predict(got, xt, return_votes=True,
                                   device="cpu")
    wl, wv = jforest.forest_predict(want, xt, return_votes=True)
    assert gl.tolist() == np.asarray(wl).tolist()
    assert gv.tobytes() == np.asarray(wv).tobytes()
    # the JAX forest walked by the port
    cl = forest.forest_predict(forest_from_jax(want), xt, device="cpu")
    assert cl.tolist() == np.asarray(wl).tolist()


def test_unknown_subset_strategy_raises_as_the_reference():
    x, y = mixture(20)
    labels = np.searchsorted(CLASSES, y).astype(np.int32)
    with pytest.raises(ValueError) as port:
        forest.train_forest(x, labels, forest.ForestConfig(
            feature_subset="half"))
    with pytest.raises(ValueError) as ref:
        jforest.train_forest(x, labels, jforest.ForestConfig(
            feature_subset="half"))
    assert str(port.value) == str(ref.value)


def test_query_wire_format_is_the_references():
    for d in ({"features": [1, 2.5, 0]}, {"attr2": 3, "attr0": 1,
                                           "attr10": 9, "attr1": 2},
              {"weight": 1.5, "height": 2}):
        assert cls.Query.from_json(d).features == \
            jcls.Query.from_json(d).features
    assert cls.PredictedResult(label="x").to_json() == \
        jcls.PredictedResult(label="x").to_json()


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """An app "classify" of 240 users with a ``$set`` of three attributes
    and a label, 10 more users lacking an attribute or the label."""
    path = tmp_path_factory.mktemp("clshome")
    x, y = mixture(240, seed=8, spread=0.6)
    st = Storage({"PIO_TPU_HOME": str(path)})
    app = st.get_metadata().app_insert("classify")
    es = st.get_event_store()
    es.init_channel(app.id)
    events = [Event(event="$set", entity_type="user", entity_id=f"u{n}",
                    properties={"attr0": float(f[0]), "attr1": float(f[1]),
                                "attr2": float(f[2]), "label": str(lab)})
              for n, (f, lab) in enumerate(zip(x, y))]
    events += [Event(event="$set", entity_type="user", entity_id=f"x{n}",
                     properties={"attr0": 1.0, "attr1": 2.0} if n % 2 else
                     {"attr0": 1.0, "attr1": 2.0, "attr2": 0.5})
               for n in range(10)]
    es.insert_batch(events, app.id)
    st.close()
    return path


VARIANT = {
    "datasource": {"params": {"appName": "classify"}},
    "algorithms": [
        {"name": "naive", "params": {"lambda": 1.0}},
        {"name": "logistic", "params": {"steps": 300}},
        {"name": "randomforest", "params": {"numTrees": 8, "maxDepth": 5,
                                            "seed": 3}},
    ],
}


def test_engine_three_algorithms_answer_as_the_jax_engine(home):
    st = Storage({"PIO_TPU_HOME": str(home)})
    jst = JaxStorage({"PIO_TPU_HOME": str(home)})
    try:
        ctx = WorkflowContext(device="cpu", storage=st)
        jctx = JaxContext(storage=jst)
        engine, jengine = cls.classification_engine(), \
            jcls.classification_engine()
        ep = engine.params_from_variant(VARIANT)
        jep = jengine.params_from_variant(VARIANT)
        data = engine._data_source(ep).read_training(ctx)
        jdata = jengine._data_source(jep).read_training(jctx)
        assert data.features.tobytes() == jdata.features.tobytes()
        assert data.labels.tolist() == jdata.labels.tolist()
        assert len(data.labels) == 240       # the incomplete users skipped
        algos, models = engine.train_components(ctx, ep)
        jalgos, jmodels = jengine.train_components(jctx, jep)
        xq, _ = mixture(64, seed=9, spread=0.6)
        queries = [{"attr0": float(a), "attr1": float(b), "attr2": float(c)}
                   for a, b, c in xq]
        pq = [cls.Query.from_json(q) for q in queries]
        jq = [jcls.Query.from_json(q) for q in queries]
        for a, m, ja, jm in zip(algos, models, jalgos, jmodels):
            a.warmup(m, max_batch=8)
            got = [r.to_json() for r in a.batch_predict(m, pq)]
            assert got == [r.to_json() for r in ja.batch_predict(jm, jq)]
            assert got == [a.predict(m, q).to_json() for q in pq]
        # persisted by run_train, loaded for deploy, the same answers
        iid = run_train(engine, ep, ctx=ctx)
        loaded = prepare_deploy(engine, ep, iid, ctx=WorkflowContext(
            device="cpu", storage=st, mode="Serving"))
        assert len(loaded) == 3
        serving = WorkflowContext(device="cpu", storage=st, mode="Serving")
        for a, m, a0, m0 in zip(engine._algorithms(ep), loaded, algos,
                                models):
            a._ctx = serving
            assert [r.to_json() for r in a.batch_predict(m, pq)] == [
                r.to_json() for r in a0.batch_predict(m0, pq)]
    finally:
        st.close()
        jst.close()
