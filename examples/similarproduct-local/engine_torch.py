"""Similar-product with a LOCAL (host-resident) model — the P2L variant
(the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
implicit ALS trains on ``ctx.device`` through the port's ``train_als``;
the model and predict stay on the host, as in the reference.

Analogue of the reference `examples/experimental/scala-parallel-
similarproduct-localmodel/` (`ALSAlgorithm.scala`, marked "MODIFIED" vs
the parallel template): training is distributed (implicit ALS on view
events) but the MODEL is collected to plain local maps and the algorithm
is a `P2LAlgorithm` — serving never touches the distributed substrate.

Device shape: train runs the same bucketed implicit-ALS as the main
template (on ``ctx.device``), then factors are pulled to host numpy once;
``placement = ModelPlacement.HOST`` routes persistence through the plain
pickle-blob path (no partition specs, no device re-placement at deploy)
and predict is pure-numpy cosine — the explicit host end of the
placement taxonomy, vs the DEVICE_SHARDED main template.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    ModelPlacement,
    Params,
)
from predictionio_tpu_torch.models.als import ALSConfig, train_als
from predictionio_tpu_torch.storage.bimap import StringIndex
from predictionio_tpu_torch.storage.columnar import Ratings


@dataclass(frozen=True)
class DataSourceParams(Params):
    views_path: str = "views.csv"
    items_path: str = "items.csv"


@dataclass(frozen=True)
class AlgoParams(Params):
    rank: int = 8
    num_iterations: int = 10
    lam: float = 0.1
    alpha: float = 1.0


@dataclass
class Query:
    items: tuple
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class Item:
    categories: tuple


@dataclass
class TrainingData:
    views: Ratings          # implicit: rating column is view counts
    items: dict             # item id -> Item


class ViewsDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        p: DataSourceParams = self.params
        pairs = [
            ln.split(",")
            for ln in Path(p.views_path).read_text().splitlines()
            if ln.strip()
        ]
        users = StringIndex.from_values(r[0] for r in pairs)
        items = StringIndex.from_values(r[1] for r in pairs)
        u = np.asarray([users[r[0]] for r in pairs], np.int64)
        i = np.asarray([items[r[1]] for r in pairs], np.int64)
        # repeat views accumulate confidence (implicit feedback counts)
        pair, counts = np.unique(u * len(items) + i, return_counts=True)
        views = Ratings(
            user_ix=(pair // len(items)).astype(np.int32),
            item_ix=(pair % len(items)).astype(np.int32),
            rating=counts.astype(np.float32),
            users=users,
            items=items,
        )
        item_props = {}
        for ln in Path(p.items_path).read_text().splitlines():
            if ln.strip():
                item_id, *cats = ln.split(",")
                item_props[item_id] = Item(categories=tuple(cats))
        return TrainingData(views=views, items=item_props)


@dataclass
class LocalModel:
    """Everything host-side: numpy factors + plain dicts (the reference's
    collected `Map[Int, Array[Double]]`)."""

    item_factors: np.ndarray
    items: StringIndex
    item_props: dict


class LocalALSAlgorithm(Algorithm):
    params_class = AlgoParams
    placement = ModelPlacement.HOST  # P2L: device train, host model

    def train(self, ctx, data: TrainingData) -> LocalModel:
        p: AlgoParams = self.params
        if len(data.views) == 0:
            raise ValueError("viewEvents cannot be empty")
        f = train_als(
            data.views,
            cfg=ALSConfig(
                rank=p.rank,
                num_iterations=p.num_iterations,
                lam=p.lam,
                implicit=True,
                alpha=p.alpha,
            ),
            device=ctx.device,
        )
        return LocalModel(
            item_factors=np.asarray(f.item_factors),
            items=data.views.items,
            item_props=data.items,
        )

    def predict(self, model: LocalModel, query: Query):
        """Pure-host cosine against the mean of the query items' vectors
        (no device dispatch at all — the point of the local variant)."""
        known = [model.items.get(i) for i in query.items]
        known = [i for i in known if i >= 0]
        if not known:
            return []
        q = model.item_factors[known].mean(axis=0)
        q /= np.linalg.norm(q) + 1e-9
        t = model.item_factors
        tn = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-9)
        scores = tn @ q
        scores[known] = -np.inf  # never recommend the query items back
        order = np.argsort(-scores)[: query.num]
        return [
            ItemScore(item=str(model.items.id_of(int(j))),
                      score=float(scores[j]))
            for j in order
            if np.isfinite(scores[j])
        ]


def engine_factory() -> Engine:
    return Engine(
        ViewsDataSource,
        IdentityPreparator,
        {"als": LocalALSAlgorithm},
        FirstServing,
    )
