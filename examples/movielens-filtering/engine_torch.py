"""Serving-time result filtering through a custom Serving component (the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: ALS
trains on ``ctx.device`` through the port's ``train_als``, the factor
tables move to that device once, at the first query, and a query is the
port's ``ops.topk.topk_scores`` there and one copy of its answer to the
host; the blocklist filter stays host post-processing.

Analogue of the reference `examples/experimental/scala-local-movielens-
filtering/` (`Filtering.scala:12-23`): the engine's SERVING stage — not
the algorithm — drops blocklisted items from the prediction, reading the
blocklist file on every request so ops can edit it without retraining or
redeploying.  The algorithm over-fetches so the response still carries
``num`` items after filtering.

Device shape: scoring is the usual one product plus top-k on the device;
the filter is pure host post-processing, exactly where the reference put
it (LServing runs on the driver).
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
from predictionio_tpu_torch.storage.columnar import Ratings
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "ratings.csv"


@dataclass(frozen=True)
class AlgoParams(Params):
    rank: int = 8
    num_iterations: int = 10
    lam: float = 0.1
    overfetch: int = 4  # score num * overfetch so filtering can't starve


@dataclass(frozen=True)
class FilterParams(Params):
    filepath: str = "blocked.txt"


@dataclass
class Query:
    user: str
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class Prediction:
    item_scores: list = field(default_factory=list)


class MovieLensDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> Ratings:
        rows = [
            ln.split(",")
            for ln in Path(self.params.path).read_text().splitlines()
            if ln.strip()
        ]
        users = StringIndex.from_values(r[0] for r in rows)
        items = StringIndex.from_values(r[1] for r in rows)
        return Ratings(
            user_ix=np.asarray([users[r[0]] for r in rows], np.int32),
            item_ix=np.asarray([items[r[1]] for r in rows], np.int32),
            rating=np.asarray([float(r[2]) for r in rows], np.float32),
            users=users,
            items=items,
        )


@dataclass
class MovieLensModel:
    user_factors: np.ndarray
    item_factors: np.ndarray
    users: StringIndex
    items: StringIndex
    device: torch.device = torch.device("cuda")

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The user and item factor tables on ``device``, moved there
        once per model (load) and reused by every query."""
        dev = getattr(self, "_dev_tables", None)
        if dev is None:
            dev = self._dev_tables = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.user_factors, self.item_factors))
        return dev


class MovieLensAlgorithm(Algorithm):
    params_class = AlgoParams

    def train(self, ctx, data: Ratings) -> MovieLensModel:
        p: AlgoParams = self.params
        f = train_als(
            data,
            cfg=ALSConfig(
                rank=p.rank, num_iterations=p.num_iterations, lam=p.lam
            ),
            device=ctx.device,
        )
        return MovieLensModel(
            user_factors=np.asarray(f.user_factors),
            item_factors=np.asarray(f.item_factors),
            users=data.users,
            items=data.items,
            device=ctx.device,
        )

    def predict(self, model: MovieLensModel, query: Query) -> Prediction:
        ui = model.users.get(query.user)
        if ui < 0:
            return Prediction()
        p: AlgoParams = self.params
        k = min(query.num * p.overfetch, len(model.items))
        users, items = model.device_tables()
        vals, ixs = topk_scores(users[ui], items, k)
        # one copy to the host per query (f64 holds every index exactly)
        vals, ixs = torch.stack((vals.double(), ixs.double())).cpu().numpy()
        return Prediction(
            item_scores=[
                ItemScore(item=str(model.items.id_of(int(j))),
                          score=float(s))
                for s, j in zip(vals, ixs)
            ]
        )


class BlocklistServing(Serving):
    """Drops blocklisted item ids from the head algorithm's prediction;
    the file is re-read per request (ops-editable, reference
    `Filtering.scala:14-22`)."""

    params_class = FilterParams

    def serve(self, query: Query, predictions) -> Prediction:
        path = Path(self.params.filepath)
        blocked = (
            {ln.strip() for ln in path.read_text().splitlines() if ln.strip()}
            if path.exists()
            else set()
        )
        pred: Prediction = predictions[0]
        kept = [s for s in pred.item_scores if s.item not in blocked]
        return Prediction(item_scores=kept[: query.num])


def engine_factory() -> Engine:
    return Engine(
        MovieLensDataSource,
        IdentityPreparator,
        {"als": MovieLensAlgorithm},
        BlocklistServing,
    )
