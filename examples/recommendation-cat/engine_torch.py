"""Category-filtered recommendation — the "-cat" template variant (the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
port's recommendation template (ALS on ``ctx.device``, device top-k with
the category mask) behind the same file data source.

Analogue of the reference `examples/experimental/scala-parallel-
recommendation-cat/`: the stock recommendation engine, extended so items
carry categories (from ``$set`` item events) and queries may restrict
results to given categories.  This example customizes ONLY the data
source (events come from a bundled JSON-lines file instead of the event
server) and reuses the template's ALS algorithm and query-time category
masking unchanged — the template-customization story the reference's
variants exist to demonstrate.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from predictionio_tpu_torch.controller import Engine, FirstServing, IdentityPreparator, Params
from predictionio_tpu_torch.storage.event import Event
from predictionio_tpu_torch.storage.levents import MemoryEventStore
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    TrainingData,
)
from predictionio_tpu_torch.controller import DataSource


@dataclass(frozen=True)
class FileDataSourceParams(Params):
    path: str = "events.jsonl"


class FileEventDataSource(DataSource):
    """Reads the same event shapes as the storage-backed template data
    source, but from a local file — items' categories come from ``$set``
    events exactly like the event-server path."""

    params_class = FileDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        es = MemoryEventStore()
        for line in Path(self.params.path).read_text().splitlines():
            if line.strip():
                es.insert(Event.from_json(json.loads(line)), app_id=1)
        frame = es.find_columnar(
            app_id=1, entity_type="user", event_names=["rate"],
            float_property="rating",
        )
        items = {
            k: dict(v.fields)
            for k, v in es.aggregate_properties_of(
                app_id=1, entity_type="item"
            ).items()
        }
        return TrainingData(
            ratings=frame.to_ratings(rating_property="rating"),
            items=items,
        )


def engine_factory() -> Engine:
    return Engine(
        FileEventDataSource,
        IdentityPreparator,
        {"als": ALSAlgorithm},
        FirstServing,
    )


__all__ = ["engine_factory", "Query"]
