"""Multi-algorithm similar-product: views ALS + likes ALS, z-score serving
(the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: both
ALS algorithms train on ``ctx.device`` through the port's ``train_als``;
each model's row-normalized item table is made once on that device, at
the first query, and a query is the port's ``ops.topk.topk_scores``
there and one copy of its answer to the host.

Analogue of the reference `examples/scala-parallel-similarproduct/multi/`
(the "multi" variant): TWO algorithms registered in one engine — one
trains on view events, one on like/dislike events (`LikeAlgorithm.scala:
16-60`, likes as +1 / dislikes as -1, summed per pair) — and a custom
Serving standardizes each algorithm's scores to z-scores before summing
them per item (`Serving.scala:13-60`), so neither algorithm's scale
dominates the blend.

Device shape: each algorithm is the usual bucketed ALS + one
cosine-top-k matmul; the z-score blend is host-side serving math, exactly
where the reference put it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    IdentityPreparator,
    Params,
    Serving,
)
from predictionio_tpu_torch.models.als import ALSConfig, train_als
from predictionio_tpu_torch.ops.topk import topk_scores
from predictionio_tpu_torch.storage.bimap import StringIndex
from predictionio_tpu_torch.storage.columnar import Ratings


@dataclass(frozen=True)
class DataSourceParams(Params):
    views_path: str = "views.csv"
    likes_path: str = "likes.csv"


@dataclass(frozen=True)
class AlgoParams(Params):
    rank: int = 8
    num_iterations: int = 10
    lam: float = 0.1


@dataclass
class Query:
    items: tuple
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class PredictedResult:
    item_scores: list = field(default_factory=list)


@dataclass
class TrainingData:
    views: Ratings       # view counts per (user, item)
    likes: Ratings       # sum of +1 like / -1 dislike per (user, item)


def _pairs_to_ratings(pairs, values, users: StringIndex,
                      items: StringIndex) -> Ratings:
    """Aggregate (user, item, value) rows by pair-sum into a COO."""
    u = np.asarray([users[a] for a, _ in pairs], np.int64)
    i = np.asarray([items[b] for _, b in pairs], np.int64)
    key = u * len(items) + i
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.bincount(inv, weights=np.asarray(values, np.float64),
                         minlength=len(uniq))
    return Ratings(
        user_ix=(uniq // len(items)).astype(np.int32),
        item_ix=(uniq % len(items)).astype(np.int32),
        rating=summed.astype(np.float32),
        users=users,
        items=items,
    )


class MultiEventDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        p: DataSourceParams = self.params
        view_rows = [
            ln.split(",")
            for ln in Path(p.views_path).read_text().splitlines()
            if ln.strip()
        ]
        like_rows = [
            ln.split(",")
            for ln in Path(p.likes_path).read_text().splitlines()
            if ln.strip()
        ]
        # one shared id space so both models score the same item table
        users = StringIndex.from_values(
            [r[0] for r in view_rows] + [r[0] for r in like_rows]
        )
        items = StringIndex.from_values(
            [r[1] for r in view_rows] + [r[1] for r in like_rows]
        )
        views = _pairs_to_ratings(
            [(r[0], r[1]) for r in view_rows],
            np.ones(len(view_rows)),
            users, items,
        )
        likes = _pairs_to_ratings(
            [(r[0], r[1]) for r in like_rows],
            [1.0 if r[2] == "like" else -1.0 for r in like_rows],
            users, items,
        )
        return TrainingData(views=views, likes=likes)


@dataclass
class FactorModel:
    item_factors: np.ndarray
    items: StringIndex
    device: torch.device = torch.device("cuda")

    def device_normalized(self) -> torch.Tensor:
        """The row-normalized item table on ``device``, normalized in f32
        as the reference normalizes it per query, once per model (load)."""
        dev = getattr(self, "_dev_normalized", None)
        if dev is None:
            t = self.item_factors
            tn = (t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-9)
                  ).astype(np.float32)
            dev = self._dev_normalized = torch.as_tensor(tn,
                                                         device=self.device)
        return dev


class _CosineALS(Algorithm):
    """Shared scoring: cosine top-k against the query items' mean vector."""

    params_class = AlgoParams

    def _ratings(self, data: TrainingData) -> Ratings:
        raise NotImplementedError

    def train(self, ctx, data: TrainingData) -> FactorModel:
        p: AlgoParams = self.params
        r = self._ratings(data)
        if len(r) == 0:
            raise ValueError(
                f"{type(self).__name__}: its event stream is empty — check "
                "DataSource/Preparator output"
            )
        f = train_als(
            r,
            cfg=ALSConfig(
                rank=p.rank, num_iterations=p.num_iterations, lam=p.lam
            ),
            device=ctx.device,
        )
        return FactorModel(
            item_factors=np.asarray(f.item_factors), items=r.items,
            device=ctx.device,
        )

    def predict(self, model: FactorModel, query: Query) -> PredictedResult:
        known = [model.items.get(i) for i in query.items]
        known = [i for i in known if i >= 0]
        if not known:
            return PredictedResult()
        t = model.item_factors
        q = t[known].mean(axis=0).astype(np.float32)
        q /= np.linalg.norm(q) + 1e-9
        # -inf bias masks out the query items at FIXED k, like the
        # similarproduct template
        k = min(query.num, len(model.items))
        tn = model.device_normalized()
        mask = torch.zeros(len(t), dtype=torch.float32, device=model.device)
        mask[known] = float("-inf")
        vals, ixs = topk_scores(torch.as_tensor(q, device=model.device), tn,
                                k, bias=mask)
        # one copy to the host per query (f64 holds every index exactly)
        vals, ixs = torch.stack((vals.double(), ixs.double())).cpu().numpy()
        return PredictedResult(
            item_scores=[
                ItemScore(item=str(model.items.id_of(int(j))),
                          score=float(s))
                for s, j in zip(vals, ixs)
                if np.isfinite(s)
            ]
        )


class ViewAlgorithm(_CosineALS):
    def _ratings(self, data: TrainingData) -> Ratings:
        return data.views


class LikeAlgorithm(_CosineALS):
    def _ratings(self, data: TrainingData) -> Ratings:
        return data.likes


class StandardizingServing(Serving):
    """z-score each algorithm's scores, sum per item, return the top num
    (reference `Serving.scala:13-60`; single-item queries skip
    standardization exactly like the reference)."""

    def serve(self, query: Query, predictions) -> PredictedResult:
        if query.num == 1:
            standardized = [p.item_scores for p in predictions]
        else:
            standardized = []
            for p in predictions:
                scores = np.asarray([s.score for s in p.item_scores])
                sd = float(scores.std()) if len(scores) else 0.0
                m = float(scores.mean()) if len(scores) else 0.0
                standardized.append([
                    ItemScore(s.item,
                              0.0 if sd == 0 else (s.score - m) / sd)
                    for s in p.item_scores
                ])
        combined: dict[str, float] = {}
        for sc_list in standardized:
            for s in sc_list:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(
            item_scores=[ItemScore(item=i, score=v) for i, v in top]
        )


def engine_factory() -> Engine:
    return Engine(
        MultiEventDataSource,
        IdentityPreparator,
        {"als": ViewAlgorithm, "likealgo": LikeAlgorithm},
        StandardizingServing,
    )
