"""Trim-app: copy a time window of events to a fresh app, as an engine
(the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the same
maintenance workflow over the port's event store (no tensor on its path).

Analogue of the reference `examples/experimental/scala-parallel-trim-app/`
(`DataSource.scala:15-55`): an "engine" whose DataSource is really a data
maintenance workflow — it reads every event of the SOURCE app inside
``[start_time, until_time)``, refuses to run if the DESTINATION app is not
empty, and writes the window there (event ids preserved).  Trimming = keep
the window, then repoint the serving app — the append-only event log is
never mutated in place, exactly the reference's approach.

The Algorithm/Serving stages are pass-through summaries (the reference's
are stubs); `pio-tpu train` is the runner.  In-place alternatives also
exist in this rebuild: ``pio-tpu app trim`` and bulk ``delete_batch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.storage.event import parse_time


@dataclass(frozen=True)
class TrimParams(Params):
    src_app_id: int = 1
    dst_app_id: int = 2
    start_time: str = ""     # ISO8601; empty = unbounded
    until_time: str = ""


@dataclass
class TrimSummary:
    copied: int
    src_app_id: int
    dst_app_id: int

    def sanity_check(self) -> None:
        if self.copied == 0:
            raise ValueError(
                "trim window matched no events — check start/until times"
            )


@dataclass
class Query:
    pass


class TrimDataSource(DataSource):
    params_class = TrimParams

    def read_training(self, ctx) -> TrimSummary:
        p: TrimParams = self.params
        es = ctx.storage.get_event_store()
        if next(iter(es.find(app_id=p.dst_app_id, limit=1)), None) is not None:
            raise RuntimeError(
                f"DstApp {p.dst_app_id} is not empty. Quitting."
            )
        window = dict(
            start_time=parse_time(p.start_time) if p.start_time else None,
            until_time=parse_time(p.until_time) if p.until_time else None,
        )
        es.init_channel(p.dst_app_id)
        copied = 0
        # atomic on every backend: sqlite defers its commit to the bulk
        # scope (rollback on failure); the explicit cleanup below covers
        # non-transactional backends (memory), where bulk() is a no-op —
        # dst was empty by precondition, so dropping it loses nothing
        try:
            with es.bulk():
                batch = []
                for e in es.find(app_id=p.src_app_id, **window):
                    batch.append(e)  # event ids ride along (event_id set)
                    if len(batch) >= 5000:
                        es.insert_batch(batch, p.dst_app_id,
                                        validate=False)
                        copied += len(batch)
                        batch = []
                if batch:
                    es.insert_batch(batch, p.dst_app_id, validate=False)
                    copied += len(batch)
        except BaseException:
            es.remove_channel(p.dst_app_id)
            raise
        return TrimSummary(
            copied=copied, src_app_id=p.src_app_id, dst_app_id=p.dst_app_id
        )


class TrimAlgorithm(Algorithm):
    """Pass-through: the 'model' is the copy summary."""

    persist_model = False  # nothing meaningful to persist

    def train(self, ctx, data: TrimSummary) -> TrimSummary:
        return data

    def predict(self, model: TrimSummary, query: Query) -> dict:
        return {
            "copied": model.copied,
            "srcAppId": model.src_app_id,
            "dstAppId": model.dst_app_id,
        }


def engine_factory() -> Engine:
    return Engine(
        TrimDataSource,
        IdentityPreparator,
        {"trim": TrimAlgorithm},
        FirstServing,
    )
