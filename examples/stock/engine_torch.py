"""Stock momentum engine over sliding price windows (the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
batched slope einsum runs on ``ctx.device`` in torch, in true f32.

Analogue of the reference `examples/experimental/scala-stock/` (windowed
`YahooDataSource` + momentum/regression strategies): the DataSource slices
a daily price table into rolling windows per ticker, the Algorithm fits a
log-price trend per window and predicts the next-period return.

Device shape: all tickers' windows are stacked into one ``[T, W]``
array and the per-window least-squares slope is a single batched einsum
against a precomputed pseudo-inverse row (closed-form OLS on a fixed
design matrix) — no per-ticker Python loops on the hot path.
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
    path: str = "prices.csv"
    window: int = 5


@dataclass(frozen=True)
class AlgoParams(Params):
    window: int = 5


@dataclass
class Query:
    ticker: str


@dataclass
class Prediction:
    ticker: str
    expected_return: float   # per-day log-return estimate
    signal: str              # "long" | "short" | "flat"


@dataclass
class TrainingData:
    tickers: StringIndex
    prices: np.ndarray  # [n_tickers, n_days] close prices


class PriceDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        series: dict[str, list[float]] = {}
        for line in Path(self.params.path).read_text().splitlines():
            if not line.strip() or line.startswith("date"):
                continue
            _, ticker, price = line.split(",")
            series.setdefault(ticker.strip(), []).append(float(price))
        tickers = StringIndex.from_values(series)
        n_days = min(len(v) for v in series.values())
        prices = np.stack(
            [np.asarray(series[t][-n_days:]) for t in tickers.ids]
        ).astype(np.float32)
        return TrainingData(tickers, prices)


@dataclass
class MomentumModel:
    tickers: StringIndex
    slopes: np.ndarray  # [n_tickers] per-day log-return trend


class MomentumAlgorithm(Algorithm):
    params_class = AlgoParams

    def train(self, ctx, td: TrainingData) -> MomentumModel:
        w = min(self.params.window, td.prices.shape[1])
        logp = torch.log(torch.as_tensor(
            np.ascontiguousarray(td.prices[:, -w:]), device=ctx.device))
        # closed-form OLS slope against time: one einsum for all tickers
        t = torch.arange(w, dtype=torch.float32, device=ctx.device)
        t = t - t.mean()
        slope_row = t / torch.sum(t * t)                   # [W]
        with matmul_precision("highest"):
            slopes = torch.einsum("tw,w->t", logp, slope_row)  # [T]
        return MomentumModel(
            tickers=td.tickers, slopes=slopes.cpu().numpy()
        )

    def predict(self, model: MomentumModel, query: Query) -> Prediction:
        ix = model.tickers.get(query.ticker)
        if ix < 0:
            return Prediction(ticker=query.ticker, expected_return=0.0,
                              signal="flat")
        s = float(model.slopes[ix])
        signal = "long" if s > 1e-4 else ("short" if s < -1e-4 else "flat")
        return Prediction(ticker=query.ticker, expected_return=s,
                          signal=signal)


def engine_factory() -> Engine:
    return Engine(
        PriceDataSource,
        IdentityPreparator,
        {"momentum": MomentumAlgorithm},
        FirstServing,
    )
