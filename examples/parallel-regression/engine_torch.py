"""Data-parallel linear regression over the mesh of shards (the port's
engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
examples are padded to a multiple of the mesh size and placed a row
block a shard (``parallel.shard_put``), each shard forms its partial
``XᵀX`` and ``Xᵀy`` on its device, the partials are summed through
``parallel.collectives.psum`` (across processes too, on a mesh that spans
them), and one solve finishes the job; a mesh of one shard takes the
same path.

Analogue of the reference `examples/experimental/scala-parallel-regression/`
(Spark MLlib SGD `LinearRegressionWithSGD` over an RDD): exact
closed-form instead of SGD, since the reduction is one product a shard.
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
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.device import matmul_precision
from predictionio_tpu_torch.parallel import pad_to_multiple, shard_put
from predictionio_tpu_torch.parallel.collectives import psum


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "data.txt"


@dataclass
class TrainingData:
    x: np.ndarray  # [N, D] features (bias column included)
    y: np.ndarray  # [N]


@dataclass
class Query:
    features: list[float] = field(default_factory=list)


class FileDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        rows = []
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                rows.append([float(v) for v in line.split(",")])
        arr = np.asarray(rows, np.float32)
        x = np.concatenate([np.ones((len(arr), 1), np.float32), arr[:, :-1]],
                           axis=1)
        return TrainingData(x=x, y=arr[:, -1])


class MeshRegressionAlgorithm(Algorithm):
    def train(self, ctx, td: TrainingData) -> np.ndarray:
        mesh = ctx.mesh
        n, d = td.x.shape
        # pad N to the mesh size with zero rows (zero contribution to
        # the moments) and shard examples over the data axis
        npad = pad_to_multiple(n, mesh.size)
        x = np.zeros((npad, d), np.float32)
        y = np.zeros((npad, 1), np.float32)
        x[:n], y[:n, 0] = td.x, td.y
        with matmul_precision("highest"):
            # per-shard partial sums, then their sum over the mesh
            parts = [torch.cat([xs.T @ xs, xs.T @ ys], dim=1)
                     for xs, ys in zip(shard_put(x, mesh),
                                       shard_put(y, mesh))]
            moments = psum(parts, mesh)[0]          # [D, D + 1]
            xtx, xty = moments[:, :d], moments[:, d]
            eye = torch.eye(d, dtype=torch.float32, device=xtx.device)
            coef = torch.linalg.solve(xtx + 1e-6 * eye, xty)
        return coef.cpu().numpy()

    def predict(self, model: np.ndarray, query: Query) -> float:
        feats = (
            query.features if isinstance(query, Query)
            else query["features"]
        )
        return float(model[0] + np.dot(model[1:], np.asarray(feats)))


def engine_factory() -> Engine:
    return Engine(
        FileDataSource,
        IdentityPreparator,
        {"regression": MeshRegressionAlgorithm},
        FirstServing,
    )
