"""Local least-squares regression on the device (the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
solve runs on ``ctx.device`` in torch, by the SVD that
``jnp.linalg.lstsq`` uses (see :func:`lstsq_svd`).

Analogue of the reference `examples/experimental/scala-local-regression`
(ReadsTrainingData from a file; a local model answering feature-vector
queries).  The model (a coefficient vector) is host-replicated — the P2L
placement class.
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
from predictionio_tpu_torch.device import matmul_precision


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "data.txt"


@dataclass
class TrainingData:
    x: np.ndarray  # [N, D] features (first column = 1 bias)
    y: np.ndarray  # [N]


@dataclass
class Query:
    features: list[float] = field(default_factory=list)


class RegressionDataSource(DataSource):
    """Reads whitespace-separated lines: ``y x1 x2 ...``."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx) -> TrainingData:
        rows = []
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                rows.append([float(t) for t in line.split()])
        data = np.asarray(rows, np.float32)
        x = np.concatenate(
            [np.ones((len(data), 1), np.float32), data[:, 1:]], axis=1
        )
        return TrainingData(x=x, y=data[:, 0])


def lstsq_svd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The least-squares coefficients of ``x @ coef ≈ y`` as
    ``jnp.linalg.lstsq`` computes them: a thin SVD, singular values below
    ``eps · max(N, D)`` of the largest dropped, the minimum-norm solution.

    Not ``torch.linalg.lstsq``: on CUDA it offers only the ``gels``
    driver (QR), which assumes full column rank and has no answer for a
    rank-deficient design, where this SVD solve gives the reference's."""
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    rcond = torch.finfo(x.dtype).eps * max(x.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    with matmul_precision("highest"):
        return vh.T @ (s_inv * (u.T @ y))


class LeastSquaresAlgorithm(Algorithm):
    def train(self, ctx, td: TrainingData) -> np.ndarray:
        coef = lstsq_svd(torch.as_tensor(td.x, device=ctx.device),
                         torch.as_tensor(td.y, device=ctx.device))
        return coef.cpu().numpy()

    def predict(self, model: np.ndarray, query) -> float:
        feats = (
            query.features if isinstance(query, Query) else query["features"]
        )
        x = np.concatenate([[1.0], np.asarray(feats, np.float32)])
        return float(x @ model)


class MeanServing(Serving):
    """Averages multi-algorithm predictions (LAverageServing analogue)."""

    def serve(self, query, predictions):
        return float(sum(predictions) / len(predictions))


def engine_factory() -> Engine:
    return Engine(
        RegressionDataSource,
        IdentityPreparator,
        {"lsq": LeastSquaresAlgorithm},
        MeanServing,
    )
