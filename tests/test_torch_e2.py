"""The port's ``e2`` library and ``models/markov.py`` against the
reference.

Seeded inputs go through both packages: categorical naive Bayes (priors,
likelihoods, log scores with the default and a custom likelihood for
unseen values, predictions), the Markov chain over string states and its
model's top-N arrays, and the k-fold split.  Both are the same Python
and numpy arithmetic in the same order: equal means bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu import e2 as ref_e2
from predictionio_tpu.e2.naive_bayes import LabeledPoint as RefPoint
from predictionio_tpu.models import markov as ref_markov
from predictionio_tpu_torch import e2
from predictionio_tpu_torch.e2.naive_bayes import LabeledPoint
from predictionio_tpu_torch.models import markov


def _points(seed: int, n: int = 300):
    """Labels over three string features whose values lean on the label."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = str(rng.choice(["spam", "ham", "eggs"], p=[0.5, 0.3, 0.2]))
        feats = tuple(f"{label[0]}{int(rng.integers(0, 4))}"
                      if rng.random() < 0.7 else f"x{int(rng.integers(0, 6))}"
                      for _ in range(3))
        out.append((label, feats))
    return out


def _both_nb(seed: int):
    pts = _points(seed)
    return (e2.train_categorical_nb([LabeledPoint(lb, f) for lb, f in pts]),
            ref_e2.train_categorical_nb([RefPoint(lb, f) for lb, f in pts]))


def test_naive_bayes_counts_equal_the_references():
    m, r = _both_nb(0)
    assert m.priors == r.priors
    assert m.likelihoods == r.likelihoods
    assert sorted(m.priors) == ["eggs", "ham", "spam"]
    with pytest.raises(ValueError):
        e2.train_categorical_nb([])


def test_naive_bayes_scores_and_predictions_equal_the_references():
    m, r = _both_nb(1)
    rng = np.random.default_rng(2)
    for _ in range(200):
        feats = tuple(str(rng.choice(["s0", "h1", "e2", "x3", "never"]))
                      for _ in range(3))
        assert m.predict(feats) == r.predict(feats)
        for label in ("spam", "ham", "eggs", "unknown"):
            assert m.log_score(LabeledPoint(label, feats)) == r.log_score(
                RefPoint(label, feats))
            assert m.log_score(LabeledPoint(label, feats),
                               default_likelihood=lambda ls: -100.0) == \
                r.log_score(RefPoint(label, feats),
                            default_likelihood=lambda ls: -100.0)
    assert m.log_score(LabeledPoint("unknown", ("a", "b", "c"))) is None
    assert m.predict(("never", "seen", "ever")) in m.priors


def _pairs(seed: int, n: int = 2_000, states: int = 30):
    rng = np.random.default_rng(seed)
    frm = rng.integers(0, states, n)
    # a few successors a state, Zipf-ish, so rows tie and overflow top_n
    to = (frm + rng.zipf(1.5, n)) % states
    return frm, to


@pytest.mark.parametrize("top_n", [1, 3, 10, 40])
def test_train_markov_chain_equals_the_references(top_n):
    frm, to = _pairs(3)
    got = markov.train_markov_chain(frm, to, 32, top_n=top_n)
    want = ref_markov.train_markov_chain(frm, to, 32, top_n=top_n)
    assert got.next_ix.dtype == want.next_ix.dtype == np.int32
    assert got.next_ix.tobytes() == want.next_ix.tobytes()
    assert got.prob.tobytes() == want.prob.tobytes()
    for s in (-1, 0, 5, 30, 31, 32):
        assert got.predict(s) == want.predict(s)
    assert got.predict(31) == [] and got.predict(32) == []


def test_the_markov_chain_over_strings_equals_the_references():
    frm, to = _pairs(4, n=500, states=12)
    trans = [(f"s{a}", f"s{b}") for a, b in zip(frm, to)]
    mc = e2.MarkovChain.train(trans, top_n=4)
    rc = ref_e2.MarkovChain.train(trans, top_n=4)
    for s in [f"s{k}" for k in range(12)] + ["zzz"]:
        assert mc.predict(s) == rc.predict(s)
    assert mc.states.ids.tolist() == rc.states.ids.tolist()
    d = dict(e2.MarkovChain.train([("a", "b"), ("a", "b"), ("a", "c"),
                                   ("b", "a")], top_n=5).predict("a"))
    assert d == pytest.approx({"b": 2 / 3, "c": 1 / 3})


@pytest.mark.parametrize("k", [1, 3, 7])
def test_split_data_equals_the_references(k):
    data = list(np.random.default_rng(k).permutation(23))
    args = ({"info": k}, lambda tr: list(tr), lambda d: ("q", d),
            lambda d: ("a", d))
    got = e2.split_data(k, data, *args)
    assert got == ref_e2.split_data(k, data, *args)
    assert sorted(d for _, _, qa in got for (_, d), _ in qa) == sorted(data)
    with pytest.raises(ValueError):
        e2.split_data(0, data, *args)
