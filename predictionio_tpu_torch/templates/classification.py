"""Classification engine template.

Port of ``predictionio_tpu/templates/classification.py`` (PredictionIO's
scala-parallel-classification: naive Bayes, plus the add-algorithm
variant's further algorithms, here logistic regression and a random
forest).  User entities carry ``$set`` properties ``attr0..attrN``
(numeric features) and ``label`` (the ``attrs`` and ``labelProperty``
params name others).  Every model is fitted on the training context's
device (the card unless ``device="cpu"`` is asked for) and is numpy
arrays; the random forest also classifies on the device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
    WorkflowContext,
)
from ..models.forest import ForestConfig, forest_predict, train_forest
from ..models.logistic import train_logistic
from ..models.naive_bayes import train_naive_bayes
from .recommendation import _resolve_app_id

__all__ = [
    "ClassificationDataSource",
    "ClassificationDataSourceParams",
    "ClassificationTrainingData",
    "LogisticAlgorithm",
    "LogisticParams",
    "NaiveBayesAlgorithm",
    "NaiveBayesParams",
    "PredictedResult",
    "Query",
    "RandomForestAlgorithm",
    "RandomForestParams",
    "classification_engine",
]


@dataclass(frozen=True)
class Query:
    features: tuple[float, ...]

    @staticmethod
    def from_json(d: dict) -> "Query":
        if "features" in d:
            return Query(features=tuple(float(x) for x in d["features"]))
        # quickstart wire format {"attr0": 2, "attr1": 0, "attr2": 0}:
        # attrN keys sort numerically (attr10 after attr9); other
        # attribute names are taken in the JSON object's own key order,
        # which must match the configured `attrs` order
        keys = list(d)
        if all(re.fullmatch(r"attr\d+", k) for k in keys):
            keys.sort(key=lambda k: int(k[4:]))
        return Query(features=tuple(float(d[k]) for k in keys))


@dataclass(frozen=True)
class PredictedResult:
    label: Any

    def to_json(self) -> dict:
        return {"label": self.label}


@dataclass(frozen=True)
class ClassificationDataSourceParams(Params):
    app_name: str = ""
    app_id: int = -1
    entity_type: str = "user"
    attrs: tuple[str, ...] = ("attr0", "attr1", "attr2")
    label_property: str = "label"


@dataclass
class ClassificationTrainingData:
    features: np.ndarray  # [n, F] float32
    labels: np.ndarray    # [n] object/str

    def sanity_check(self) -> None:
        if len(self.labels) == 0:
            raise ValueError("no labeled entities found")
        if len(np.unique(self.labels)) < 2:
            raise ValueError("need at least two classes to train")


class ClassificationDataSource(DataSource):
    params_class = ClassificationDataSourceParams

    def read_training(self, ctx: WorkflowContext) -> ClassificationTrainingData:
        p = self.params
        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        props = es.aggregate_properties_of(
            app_id=app_id, entity_type=p.entity_type,
            required=list(p.attrs) + [p.label_property],
        )
        feats, labels = [], []
        for pm in props.values():
            feats.append([float(pm.get(a)) for a in p.attrs])
            labels.append(str(pm.get(p.label_property)))
        return ClassificationTrainingData(
            features=np.asarray(feats, np.float32) if feats else
            np.zeros((0, len(p.attrs)), np.float32),
            labels=np.asarray(labels, dtype=object),
        )


def _batch_classify(model, queries):
    """One vectorized ``model.predict`` for the whole query set."""
    if not queries:
        return []
    X = np.asarray([q.features for q in queries], np.float32)
    return [PredictedResult(label=lab) for lab in model.predict(X)]


@dataclass(frozen=True)
class NaiveBayesParams(Params):
    __param_aliases__ = {"lambda": "lam"}

    lam: float = 1.0


class NaiveBayesAlgorithm(Algorithm):
    """(reference `NaiveBayesAlgorithm.scala:16-28`)"""

    params_class = NaiveBayesParams

    def train(self, ctx, data: ClassificationTrainingData):
        return train_naive_bayes(data.features, data.labels,
                                 lam=self.params.lam, device=ctx.device)

    def predict(self, model, query: Query) -> PredictedResult:
        label = model.predict(np.asarray(query.features, np.float32))[0]
        return PredictedResult(label=label)

    def batch_predict(self, model, queries):
        return _batch_classify(model, queries)


@dataclass(frozen=True)
class LogisticParams(Params):
    lr: float = 0.1
    steps: int = 300
    l2: float = 1e-4


class LogisticAlgorithm(Algorithm):
    """Softmax regression trained on the card (the classification
    config's second algorithm)."""

    params_class = LogisticParams

    def train(self, ctx, data: ClassificationTrainingData):
        p = self.params
        return train_logistic(
            data.features, data.labels, lr=p.lr, steps=p.steps, l2=p.l2,
            device=ctx.device,
        )

    def predict(self, model, query: Query) -> PredictedResult:
        label = model.predict(np.asarray(query.features, np.float32))[0]
        return PredictedResult(label=label)

    def batch_predict(self, model, queries):
        return _batch_classify(model, queries)


@dataclass(frozen=True)
class RandomForestParams(Params):
    """The reference's param names (`RandomForestAlgorithm.scala:2-9`);
    maxBins and impurity are not carried: the forest searches exact
    thresholds by gini (the reference example's default)."""

    num_trees: int = 16
    max_depth: int = 6
    # MLlib vocabulary: sqrt/auto, log2, onethird, all
    feature_subset_strategy: str = "sqrt"
    seed: int = 0


class RandomForestAlgorithm(Algorithm):
    """Random forest, the add-algorithm variant's third algorithm
    (`add-algorithm/.../RandomForestAlgorithm.scala:1-60`): host-fitted
    CART trees stored as tensors, classified by a lock-step tree walk on
    the serving context's device (``models/forest.py``)."""

    params_class = RandomForestParams

    def train(self, ctx, data: ClassificationTrainingData):
        p = self.params
        self._ctx = ctx  # the device the walk runs on
        classes = sorted({str(lab) for lab in data.labels.tolist()})
        lut = {c: i for i, c in enumerate(classes)}
        y = np.asarray([lut[str(lab)] for lab in data.labels], np.int32)
        forest = train_forest(
            data.features, y,
            ForestConfig(
                n_trees=p.num_trees,
                max_depth=p.max_depth,
                num_classes=len(classes),
                # passed through verbatim: train_forest rejects an
                # unknown strategy
                feature_subset=p.feature_subset_strategy,
                seed=p.seed,
            ),
        )
        return {"forest": forest, "classes": classes}

    def _walk(self, model, X):
        """The forest walk on the serving (or training) context's
        device, the card when the algorithm has no context."""
        ctx = getattr(self, "_ctx", None)
        return forest_predict(model["forest"], X,
                              device=ctx.device if ctx else "cuda")

    def warmup(self, model, max_batch: int = 64) -> None:
        """Run the walk once at every pow2 batch the serving batcher can
        dispatch (at B=1 with the batcher off), so the first query pays
        no one-time device set-up.  A model saved without its feature
        width skips it."""
        from ._common import pow2_ladder

        f = model["forest"].n_features
        if f <= 0:
            return
        for b in pow2_ladder(max_batch) or [1]:
            self._walk(model, np.zeros((b, f), np.float32))

    def predict(self, model, query: Query) -> PredictedResult:
        ix = self._walk(model, np.asarray([query.features], np.float32))[0]
        return PredictedResult(label=model["classes"][int(ix)])

    def batch_predict(self, model, queries):
        """The whole query set through one forest walk."""
        if not queries:
            return []
        ixs = self._walk(
            model, np.asarray([q.features for q in queries], np.float32))
        return [
            PredictedResult(label=model["classes"][int(i)]) for i in ixs
        ]


def classification_engine() -> Engine:
    return Engine(
        ClassificationDataSource,
        IdentityPreparator,
        {"naive": NaiveBayesAlgorithm, "logistic": LogisticAlgorithm,
         "randomforest": RandomForestAlgorithm,
         "": NaiveBayesAlgorithm},
        FirstServing,
    )


# -- registration --------------------------------------------------------


def _conformance_events():
    """16 users' ``$set`` of three attributes and a hot/cold label: the
    reference fixture's events."""
    from ..storage import DataMap, Event

    events = []
    for n in range(16):
        label = "hot" if n % 2 == 0 else "cold"
        base = 3.0 if label == "hot" else 0.0
        events.append(Event(
            event="$set", entity_type="user", entity_id=f"u{n}",
            properties=DataMap({
                "attr0": base + (n % 3) * 0.1,
                "attr1": float(n % 2),
                "attr2": base * 0.5,
                "label": label,
            }),
        ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

classification_engine = engine_spec(
    "classification",
    description=(
        "Attribute classification: naive bayes / logistic / random "
        "forest on the GPU (scala-parallel-classification analogue)"
    ),
    default_params={
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}],
    },
    query_example={"features": [2.0, 0.0, 0.0]},
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"features": [3.1, 0.0, 1.5]},),
        check=lambda r: r.get("label") in ("hot", "cold"),
        variant={
            "datasource": {"params": {"appName": "forge-conf"}},
            "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}],
        },
    ),
)(classification_engine)
