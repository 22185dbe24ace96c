"""Controller DSL — the user-facing engine-building API (copy of
``predictionio_tpu/controller``'s base, engine and params modules; the
evaluation layer is not ported yet)."""

from .base import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    ModelPlacement,
    Preparator,
    SanityCheck,
    Serving,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    TrainingInterrupted,
    WorkflowContext,
    instantiate,
)
from .engine import Engine, EngineFactory, EngineParams, SimpleEngine
from .params import EmptyParams, Params, ParamsError, extract_params, params_to_json

__all__ = [
    "Algorithm",
    "AverageServing",
    "DataSource",
    "FirstServing",
    "IdentityPreparator",
    "ModelPlacement",
    "Preparator",
    "SanityCheck",
    "Serving",
    "StopAfterPrepareInterruption",
    "StopAfterReadInterruption",
    "TrainingInterrupted",
    "WorkflowContext",
    "instantiate",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "SimpleEngine",
    "EmptyParams",
    "Params",
    "ParamsError",
    "extract_params",
    "params_to_json",
]
