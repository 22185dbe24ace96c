"""Friend recommendation by keyword similarity (KDD-2012 scenario; the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
model keeps the packed keyword matrices on the host for the scalar
path and on ``ctx.device`` for the batch path, whose product runs there
in true f32 (``device.matmul_precision("highest")``).

Analogue of the reference `examples/experimental/scala-local-friend-
recommendation/` (`KeywordSimilarityAlgorithm.scala`): users and items carry
keyword->weight maps; given (user, item), the prediction is the keyword
similarity (sum over shared keywords of the weight product,
`KeywordSimilarityAlgorithm.scala:37-44`) plus an acceptance decision
``sim * weight >= threshold`` (`:46-60`).

Device shape: the keyword maps are packed into dense ``[n, K]`` weight
matrices at train time, so a (user, item) query is one vector dot product
and a batch of queries is one matmul — no per-keyword hash lookups on the
scoring path.
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
from predictionio_tpu_torch.device import matmul_precision
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    user_path: str = "user_keywords.csv"
    item_path: str = "item_keywords.csv"


@dataclass(frozen=True)
class AlgoParams(Params):
    sim_weight: float = 1.0
    threshold: float = 1.0


@dataclass
class Query:
    user: str
    item: str


@dataclass
class Prediction:
    confidence: float
    acceptance: bool


@dataclass
class TrainingData:
    users: StringIndex
    items: StringIndex
    keywords: StringIndex
    user_kw: np.ndarray  # [n_users, K] weights
    item_kw: np.ndarray  # [n_items, K] weights


def _read_keyword_csv(path: str):
    """Lines of ``id,kw:weight,kw:weight,...``."""
    rows = {}
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        parts = line.split(",")
        rows[parts[0].strip()] = {
            kw.strip(): float(w)
            for kw, w in (p.split(":") for p in parts[1:] if p.strip())
        }
    return rows


class FriendDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        u_rows = _read_keyword_csv(self.params.user_path)
        i_rows = _read_keyword_csv(self.params.item_path)
        users = StringIndex.from_values(u_rows)
        items = StringIndex.from_values(i_rows)
        keywords = StringIndex.from_values(
            kw for rows in (u_rows, i_rows) for m in rows.values() for kw in m
        )
        uk = np.zeros((len(users), len(keywords)), np.float32)
        ik = np.zeros((len(items), len(keywords)), np.float32)
        for rid, m in u_rows.items():
            for kw, w in m.items():
                uk[users[rid], keywords[kw]] = w
        for rid, m in i_rows.items():
            for kw, w in m.items():
                ik[items[rid], keywords[kw]] = w
        return TrainingData(users, items, keywords, uk, ik)


@dataclass
class KeywordSimilarityModel:
    users: StringIndex
    items: StringIndex
    user_kw: np.ndarray
    item_kw: np.ndarray
    sim_weight: float
    threshold: float
    device: torch.device = torch.device("cuda")

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The keyword matrices on ``device``, moved there once per model
        (load) and reused by every batch."""
        dev = getattr(self, "_dev_tables", None)
        if dev is None:
            dev = self._dev_tables = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.user_kw, self.item_kw))
        return dev


class KeywordSimilarityAlgorithm(Algorithm):
    params_class = AlgoParams

    def train(self, ctx, td: TrainingData) -> KeywordSimilarityModel:
        p = self.params
        return KeywordSimilarityModel(
            users=td.users, items=td.items,
            user_kw=td.user_kw, item_kw=td.item_kw,
            sim_weight=p.sim_weight, threshold=p.threshold,
            device=ctx.device,
        )

    def predict(self, model: KeywordSimilarityModel, query: Query) -> Prediction:
        ui = model.users.get(query.user)
        ii = model.items.get(query.item)
        if ui < 0 or ii < 0:
            # unseen users/items score 0, like the reference (`:58-62`)
            return Prediction(confidence=0.0, acceptance=False)
        sim = float(model.user_kw[ui] @ model.item_kw[ii])
        return Prediction(
            confidence=sim,
            acceptance=sim * model.sim_weight >= model.threshold,
        )

    def batch_predict(self, model, queries):
        """All queries in one product on the model's device (the payoff
        of dense packing)."""
        uix = np.array([model.users.get(q.user) for q in queries])
        iix = np.array([model.items.get(q.item) for q in queries])
        ok = (uix >= 0) & (iix >= 0)
        sims = np.zeros(len(queries), np.float32)
        if ok.any():
            user_kw, item_kw = model.device_tables()
            rows = [torch.as_tensor(ix[ok], device=model.device)
                    for ix in (uix, iix)]
            with matmul_precision("highest"):
                s = torch.einsum("qk,qk->q", user_kw[rows[0]],
                                 item_kw[rows[1]])
            sims[ok] = s.cpu().numpy()
        # unseen users/items are hard-rejected like the scalar path (NOT
        # run through the threshold test, which a threshold <= 0 would pass)
        return [
            Prediction(
                confidence=float(s),
                acceptance=bool(
                    k and s * model.sim_weight >= model.threshold
                ),
            )
            for s, k in zip(sims, ok)
        ]


def engine_factory() -> Engine:
    return Engine(
        FriendDataSource,
        IdentityPreparator,
        {"keyword_similarity": KeywordSimilarityAlgorithm},
        FirstServing,
    )
