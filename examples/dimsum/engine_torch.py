"""All-pairs item-item cosine similarity ("DIMSUM" analogue; the port's
engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
column normalization, the Gram product and the top-N run on
``ctx.device`` in torch, in true f32, where the reference runs them in
XLA (no kernel of its own: the torch ops are the port).  The top-N is
the port's ``ops.topk.batch_topk_scores``, which orders equal scores by
the lower index, as ``jax.lax.top_k`` does, on every device.

Analogue of the reference `examples/experimental/scala-parallel-
similarproduct-dimsum/` (`DIMSUMAlgorithm.scala`), which uses Spark MLlib's
DIMSUM sampling to APPROXIMATE all-pairs column cosine similarity of the
user x item rating matrix — sampling is needed because an exact all-pairs
pass is shuffle-bound on a cluster.

Device shape: the exact computation is one Gram product on the device
(``S = Ĉᵀ Ĉ`` over the column-normalized rating matrix), so no sampling or
similarity threshold is needed — the "approximation knob" disappears and
the model is the exact top-N similarity lists.
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
from predictionio_tpu_torch.ops.topk import batch_topk_scores
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "ratings.csv"


@dataclass(frozen=True)
class AlgoParams(Params):
    top_n: int = 10


@dataclass
class Query:
    items: tuple
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class TrainingData:
    users: StringIndex
    items: StringIndex
    matrix: np.ndarray  # [n_users, n_items] ratings (0 = unrated)


class RatingsDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        triples = []
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                u, i, r = line.split(",")
                triples.append((u.strip(), i.strip(), float(r)))
        users = StringIndex.from_values(t[0] for t in triples)
        items = StringIndex.from_values(t[1] for t in triples)
        m = np.zeros((len(users), len(items)), np.float32)
        for u, i, r in triples:
            m[users[u], items[i]] = r
        return TrainingData(users, items, m)


@dataclass
class SimilarityModel:
    items: StringIndex
    top_items: np.ndarray   # [n_items, top_n] int32 neighbor indices
    top_scores: np.ndarray  # [n_items, top_n] cosine scores


class CosineSimilarityAlgorithm(Algorithm):
    params_class = AlgoParams

    def train(self, ctx, td: TrainingData) -> SimilarityModel:
        n = len(td.items)
        top_n = min(self.params.top_n, n - 1)
        C = torch.as_tensor(td.matrix, device=ctx.device)
        # column-normalize, then ONE Gram product = exact all-pairs cosine
        norms = torch.linalg.vector_norm(C, dim=0, keepdim=True)
        CnT = (C / torch.clamp_min(norms, 1e-9)).T.contiguous()  # Ĉᵀ
        # S = Ĉᵀ Ĉ - 2 I (self-similarity excluded), top-N of each row
        eye = torch.eye(n, dtype=torch.float32, device=ctx.device)
        scores, idx = batch_topk_scores(CnT, CnT, top_n, mask=-2.0 * eye)
        return SimilarityModel(
            items=td.items,
            top_items=idx.to(torch.int32).cpu().numpy(),
            top_scores=scores.cpu().numpy(),
        )

    def predict(self, model: SimilarityModel, query: Query):
        known = [model.items.get(i) for i in query.items]
        known = [i for i in known if i >= 0]
        if not known:
            return []
        # merge the query items' neighbor lists, best score per neighbor
        best: dict[int, float] = {}
        for ix in known:
            for j, s in zip(model.top_items[ix], model.top_scores[ix]):
                j = int(j)
                if j in known:
                    continue
                if s > best.get(j, -np.inf):
                    best[j] = float(s)
        ranked = sorted(best.items(), key=lambda kv: -kv[1])[: query.num]
        return [
            ItemScore(item=str(model.items.id_of(j)), score=s)
            for j, s in ranked
        ]


def engine_factory() -> Engine:
    return Engine(
        RatingsDataSource,
        IdentityPreparator,
        {"cosine": CosineSimilarityAlgorithm},
        FirstServing,
    )
