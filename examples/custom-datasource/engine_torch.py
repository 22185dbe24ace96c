"""Recommendation engine with a custom (non-event-store) DataSource (the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: ALS
trains on ``ctx.device`` through the port's ``train_als``, and the
model's factor tables move to that device once, at the first query, so a
query is the port's ``ops.topk.topk_scores`` on the device and one copy
of its answer to the host.

Analogue of the reference `examples/experimental/scala-parallel-
recommendation-custom-datasource/` (DataSource reading a raw ratings file
instead of the Event Server) and `-entitymap` (building the contiguous id
dictionaries by hand with `BiMap`/`EntityMap`): the DataSource parses
``ratings.csv``, builds `StringIndex` dictionaries, and hands a COO to the
same block-ALS the event-store template uses — demonstrating that the
DataSource contract is the only coupling point.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.models.als import ALSConfig, ALSFactors, train_als
from predictionio_tpu_torch.ops.topk import topk_scores
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "ratings.csv"


@dataclass(frozen=True)
class ALSParams(Params):
    __param_aliases__ = {"lambda": "lam"}

    rank: int = 8
    num_iterations: int = 10
    lam: float = 0.1
    seed: int = 3


@dataclass
class Query:
    user: str
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class TrainingData:
    users: StringIndex
    items: StringIndex
    u: np.ndarray
    i: np.ndarray
    v: np.ndarray


class CsvRatingsDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        triples = []
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                u, i, r = line.split(",")
                triples.append((u.strip(), i.strip(), float(r)))
        # the BiMap.stringInt analogue: deterministic contiguous indexing
        users = StringIndex.from_values(t[0] for t in triples)
        items = StringIndex.from_values(t[1] for t in triples)
        return TrainingData(
            users=users,
            items=items,
            u=np.asarray([users[t[0]] for t in triples], np.int32),
            i=np.asarray([items[t[1]] for t in triples], np.int32),
            v=np.asarray([t[2] for t in triples], np.float32),
        )


@dataclass
class Model:
    users: StringIndex
    items: StringIndex
    factors: ALSFactors
    device: torch.device = torch.device("cuda")

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The user and item factor tables on ``device``, moved there
        once per model (load) and reused by every query."""
        dev = getattr(self, "_dev_tables", None)
        if dev is None:
            dev = self._dev_tables = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.factors.user_factors,
                          self.factors.item_factors))
        return dev


class CsvALSAlgorithm(Algorithm):
    params_class = ALSParams

    def train(self, ctx, td: TrainingData) -> Model:
        p = self.params
        factors = train_als(
            (td.u, td.i, td.v), len(td.users), len(td.items),
            ALSConfig(rank=p.rank, num_iterations=p.num_iterations,
                      lam=p.lam, seed=p.seed),
            device=ctx.device,
        )
        return Model(users=td.users, items=td.items, factors=factors,
                     device=ctx.device)

    def predict(self, model: Model, query: Query):
        ui = model.users.get(query.user)
        if ui < 0:
            return []
        k = min(query.num, len(model.items))
        users, items = model.device_tables()
        vals, ixs = topk_scores(users[ui], items, k)
        # one copy to the host per query (f64 holds every index exactly)
        vals, ixs = torch.stack((vals.double(), ixs.double())).cpu().numpy()
        return [
            ItemScore(item=str(model.items.id_of(int(j))), score=float(s))
            for s, j in zip(vals, ixs)
        ]


def engine_factory() -> Engine:
    return Engine(
        CsvRatingsDataSource,
        IdentityPreparator,
        {"als": CsvALSAlgorithm},
        FirstServing,
    )
