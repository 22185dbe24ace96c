"""MovieLens-style evaluation workflow: k-fold RMSE hyperparameter sweep
(the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: each
candidate's ALS trains on ``ctx.device`` through the port's
``train_als``; a (user, item) prediction is one dot product of the
host factor arrays, as in the reference.

Analogue of the reference `examples/experimental/scala-local-movielens-
evaluation/` (`Evaluation.scala`: MetricEvaluator over a MovieLens engine).
A file-backed ratings DataSource provides ``read_eval`` k-folds, ALS is
swept over rank candidates, and ``run_evaluation`` picks the argmax —
the full `pio eval` path without an event server.

Run: ``python engine_torch.py`` (on the card; ``--device cpu`` on the
host) prints the evaluation's one-line result (also writes
``best.json``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.models.als import ALSConfig, ALSFactors, train_als
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    path: str = "ratings.csv"
    eval_k: int = 3


@dataclass(frozen=True)
class ALSParams(Params):
    __param_aliases__ = {"lambda": "lam"}

    rank: int = 4
    num_iterations: int = 5
    lam: float = 0.1
    seed: int = 3


@dataclass
class Query:
    user: str
    item: str


@dataclass
class TrainingData:
    users: StringIndex
    items: StringIndex
    u: np.ndarray
    i: np.ndarray
    v: np.ndarray


def _read(path: str):
    triples = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            u, i, r = line.split(",")
            triples.append((u.strip(), i.strip(), float(r)))
    return triples


class FileRatingsDataSource(DataSource):
    params_class = DataSourceParams

    def _td(self, triples) -> TrainingData:
        users = StringIndex.from_values(t[0] for t in triples)
        items = StringIndex.from_values(t[1] for t in triples)
        return TrainingData(
            users=users,
            items=items,
            u=np.asarray([users[t[0]] for t in triples], np.int32),
            i=np.asarray([items[t[1]] for t in triples], np.int32),
            v=np.asarray([t[2] for t in triples], np.float32),
        )

    def read_training(self, ctx) -> TrainingData:
        return self._td(_read(self.params.path))

    def read_eval(self, ctx):
        """k-fold split, e2 `CrossValidation.scala:33-63` semantics."""
        triples = _read(self.params.path)
        rng = np.random.default_rng(7)
        order = rng.permutation(len(triples))
        folds = []
        for k in range(self.params.eval_k):
            hold = {int(ix) for ix in order[k :: self.params.eval_k]}
            train = [t for j, t in enumerate(triples) if j not in hold]
            test = [t for j, t in enumerate(triples) if j in hold]
            qa = [(Query(user=u, item=i), r) for u, i, r in test]
            folds.append((self._td(train), {"fold": k}, qa))
        return folds


@dataclass
class ALSModel:
    users: StringIndex
    items: StringIndex
    factors: ALSFactors
    mean: float


class EvalALSAlgorithm(Algorithm):
    params_class = ALSParams

    def train(self, ctx, td: TrainingData) -> ALSModel:
        p = self.params
        factors = train_als(
            (td.u, td.i, td.v), len(td.users), len(td.items),
            ALSConfig(rank=p.rank, num_iterations=p.num_iterations,
                      lam=p.lam, seed=p.seed),
            device=ctx.device,
        )
        return ALSModel(users=td.users, items=td.items, factors=factors,
                        mean=float(td.v.mean()))

    def predict(self, model: ALSModel, query: Query) -> float:
        ui = model.users.get(query.user)
        ii = model.items.get(query.item)
        if ui < 0 or ii < 0:
            return model.mean  # cold-start fallback
        return float(
            model.factors.user_factors[ui] @ model.factors.item_factors[ii]
        )


class SquaredError(AverageMetric):
    """RMSE surrogate: mean squared error (lower is better)."""

    @property
    def header(self) -> str:
        return "MSE"

    def compare(self, a: float, b: float) -> int:
        # lower error wins
        if a == b:
            return 0
        return 1 if a < b else -1

    def calculate_point(self, query, predicted, actual) -> float:
        return (predicted - actual) ** 2


def engine_factory() -> Engine:
    return Engine(
        FileRatingsDataSource,
        IdentityPreparator,
        {"als": EvalALSAlgorithm},
        FirstServing,
    )


def evaluation_factory() -> Evaluation:
    return Evaluation(engine_factory(), SquaredError())


def engine_params_list():
    return [
        EngineParams(
            data_source=("", DataSourceParams()),
            algorithms=[("als", ALSParams(rank=r, num_iterations=it))],
        )
        for r, it in [(2, 2), (6, 8)]
    ]


def main(argv=None) -> None:
    import argparse

    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.workflow import run_evaluation

    ap = argparse.ArgumentParser(description="k-fold RMSE sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ctx = WorkflowContext(device=ap.parse_args(argv).device,
                          mode="Evaluation")
    _, result = run_evaluation(evaluation_factory(), engine_params_list(),
                               ctx=ctx)
    print(result.to_one_liner())


if __name__ == "__main__":
    main()
