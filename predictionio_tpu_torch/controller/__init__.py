"""Controller DSL — the user-facing engine-building API (copy of
``predictionio_tpu/controller``: base, engine, params, and the
evaluation layer: metrics, evaluation and FastEval)."""

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
from .evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from .fast_eval import FastEvalEngine
from .metrics import (
    ActualItems,
    AverageMetric,
    MAPatK,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    QPAMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
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
    "EngineParamsGenerator",
    "Evaluation",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "FastEvalEngine",
    "ActualItems",
    "AverageMetric",
    "MAPatK",
    "Metric",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "QPAMetric",
    "StdevMetric",
    "SumMetric",
    "ZeroMetric",
    "EngineFactory",
    "EngineParams",
    "SimpleEngine",
    "EmptyParams",
    "Params",
    "ParamsError",
    "extract_params",
    "params_to_json",
]
