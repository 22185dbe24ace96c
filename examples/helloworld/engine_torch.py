"""HelloWorld: predict a day's average temperature (the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the same
engine with the port's controller DSL.

Analogue of the reference `examples/experimental/scala-local-helloworld/
HelloWorld.scala`: a minimal local engine — DataSource reads
``data/helloworld/data.csv`` lines of ``day,temperature``, the Algorithm
averages per day, predict returns the day's mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
)


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "data.csv"


@dataclass
class Query:
    day: str


@dataclass
class PredictedResult:
    temperature: float


class HelloDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx):
        readings: dict[str, list[float]] = {}
        for line in Path(self.params.path).read_text().splitlines():
            if not line.strip():
                continue
            day, temp = line.split(",")
            readings.setdefault(day.strip(), []).append(float(temp))
        return readings


class HelloAlgorithm(Algorithm):
    def train(self, ctx, prepared_data):
        return {
            day: sum(temps) / len(temps)
            for day, temps in prepared_data.items()
        }

    def predict(self, model, query: Query) -> PredictedResult:
        day = query.day if isinstance(query, Query) else query["day"]
        return PredictedResult(temperature=model[day])


def engine_factory() -> Engine:
    return Engine(
        HelloDataSource,
        IdentityPreparator,
        {"algo": HelloAlgorithm},
        FirstServing,
    )
