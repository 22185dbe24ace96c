"""Next-state prediction with the e2 MarkovChain library (the port's
engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the same
engine over the port's ``e2.MarkovChain`` (numpy on the host, as in the
reference).

Shows the e2 library (reference `e2/engine/MarkovChain.scala`) inside a
full engine: DataSource reads ``prev next`` transition lines, the model is
a row-normalized top-N transition matrix.
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
from predictionio_tpu_torch.e2.markov_chain import MarkovChain


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "transitions.txt"


@dataclass
class Query:
    state: str


class TransitionDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx) -> list[tuple[str, str]]:
        pairs = []
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                a, b = line.split()
                pairs.append((a, b))
        return pairs


@dataclass(frozen=True)
class MarkovParams(Params):
    top_n: int = 3


class MarkovAlgorithm(Algorithm):
    params_class = MarkovParams

    def __init__(self, params: MarkovParams = MarkovParams()):
        self.params = params

    def train(self, ctx, transitions) -> MarkovChain:
        return MarkovChain.train(transitions, top_n=self.params.top_n)

    def predict(self, model: MarkovChain, query):
        state = query.state if isinstance(query, Query) else query["state"]
        return model.predict(state)


def engine_factory() -> Engine:
    return Engine(
        TransitionDataSource,
        IdentityPreparator,
        {"markov": MarkovAlgorithm},
        FirstServing,
    )
