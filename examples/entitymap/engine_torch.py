"""Typed entity extraction + heterogeneous event->rating mapping (the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: ALS
trains on ``ctx.device`` through the port's ``train_als``, the factor
tables move to that device once, at the first query, and a query is the
port's ``ops.topk.topk_scores`` there and one copy of its answer to the
host.

Analogue of the reference `examples/experimental/scala-parallel-
recommendation-entitymap/` (`DataSource.scala:26-81`): build TYPED entity
maps from ``$set`` property events with required-attribute filtering
(`PEvents.extractEntityMap`), read a MIX of event types ("rate" carries a
rating property, "buy" maps to the fixed rating 4.0), and train ALS on the
result.  Predictions resolve back through the item EntityMap so each
recommended id returns its typed payload, not just a string.

Device shape: the entity maps stay host-side (pure bookkeeping); the
training COO is encoded against the maps' contiguous indices and goes
through the same bucketed static-shape ALS as the main template.
"""

from __future__ import annotations

import json
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
from predictionio_tpu_torch.models.als import ALSConfig, train_als
from predictionio_tpu_torch.ops.topk import topk_scores
from predictionio_tpu_torch.storage.bimap import EntityMap
from predictionio_tpu_torch.storage.columnar import Ratings
from predictionio_tpu_torch.storage.event import Event
from predictionio_tpu_torch.storage.levents import MemoryEventStore


@dataclass(frozen=True)
class User:
    attr0: float
    attr1: int
    attr2: int


@dataclass(frozen=True)
class Item:
    attrA: str
    attrB: int
    attrC: bool


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "events.jsonl"
    buy_rating: float = 4.0  # reference maps "buy" events to rating 4.0


@dataclass(frozen=True)
class AlgoParams(Params):
    rank: int = 8
    num_iterations: int = 10
    lam: float = 0.1


@dataclass
class Query:
    user: str
    num: int = 4


@dataclass
class ScoredItem:
    item: str
    score: float
    payload: Item


@dataclass
class TrainingData:
    users: EntityMap
    items: EntityMap
    ratings: Ratings


class EntityMapDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        p: DataSourceParams = self.params
        es = MemoryEventStore()
        for line in Path(p.path).read_text().splitlines():
            if line.strip():
                es.insert(Event.from_json(json.loads(line)), app_id=1)

        # typed maps; entities missing a required attribute are dropped
        users = es.extract_entity_map(
            lambda dm: User(
                attr0=dm.get_float("attr0"),
                attr1=dm.get_int("attr1"),
                attr2=dm.get_int("attr2"),
            ),
            app_id=1,
            entity_type="user",
            required=["attr0", "attr1", "attr2"],
        )
        items = es.extract_entity_map(
            lambda dm: Item(
                attrA=dm.get_string("attrA"),
                attrB=dm.get_int("attrB"),
                attrC=bool(dm["attrC"]),
            ),
            app_id=1,
            entity_type="item",
            required=["attrA", "attrB", "attrC"],
        )

        u_ix, i_ix, vals = [], [], []
        for e in es.find(app_id=1, event_names=["rate", "buy"]):
            ui = users.id_to_ix.get(e.entity_id)
            ii = items.id_to_ix.get(e.target_entity_id)
            if ui < 0 or ii < 0:
                continue  # events about filtered-out entities
            v = (
                e.properties.get_float("rating")
                if e.event == "rate"
                else p.buy_rating
            )
            u_ix.append(ui)
            i_ix.append(ii)
            vals.append(v)
        ratings = Ratings(
            user_ix=np.asarray(u_ix, np.int32),
            item_ix=np.asarray(i_ix, np.int32),
            rating=np.asarray(vals, np.float32),
            users=users.id_to_ix.index,
            items=items.id_to_ix.index,
        )
        return TrainingData(users=users, items=items, ratings=ratings)


@dataclass
class EntityALSModel:
    user_factors: np.ndarray
    item_factors: np.ndarray
    users: EntityMap
    items: EntityMap
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


class EntityALSAlgorithm(Algorithm):
    params_class = AlgoParams

    def train(self, ctx, data: TrainingData) -> EntityALSModel:
        p: AlgoParams = self.params
        f = train_als(
            data.ratings,
            cfg=ALSConfig(
                rank=p.rank, num_iterations=p.num_iterations, lam=p.lam
            ),
            device=ctx.device,
        )
        return EntityALSModel(
            user_factors=np.asarray(f.user_factors),
            item_factors=np.asarray(f.item_factors),
            users=data.users,
            items=data.items,
            device=ctx.device,
        )

    def predict(self, model: EntityALSModel, query: Query):
        ui = model.users.id_to_ix.get(query.user)
        if ui < 0:
            return []
        k = min(query.num, len(model.items))
        users, items = model.device_tables()
        vals, ixs = topk_scores(users[ui], items, k)
        # one copy to the host per query (f64 holds every index exactly)
        vals, ixs = torch.stack((vals.double(), ixs.double())).cpu().numpy()
        return [
            ScoredItem(
                item=model.items.id_to_ix.inverse(int(j)),
                score=float(s),
                payload=model.items.get_by_index(int(j)),
            )
            for s, j in zip(vals, ixs)
        ]


def engine_factory() -> Engine:
    return Engine(
        EntityMapDataSource,
        IdentityPreparator,
        {"als": EntityALSAlgorithm},
        FirstServing,
    )
