"""Evaluation + hyperparameter sweep.

Copy of ``predictionio_tpu/controller/evaluation.py`` for the port: each
scored candidate is an ``eval.sweep`` phase span and a ``candidate``
record of the run manifest, and its log line carries its score and
seconds.

Re-expression of reference `controller/Evaluation.scala:32-96`,
`controller/MetricEvaluator.scala:144-221` and
`controller/EngineParamsGenerator`: score every EngineParams candidate with
the engine's eval pipeline, pick the argmax under ``metric.compare``, record
per-candidate logs, and emit one-liner/HTML/JSON renderings plus a
``best.json`` engine variant.
"""

from __future__ import annotations

import html as _html
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

from ..obs import phase_span, tower
from .base import WorkflowContext
from .engine import Engine, EngineParams
from .metrics import Metric
from .params import params_to_json

logger = logging.getLogger(__name__)

__all__ = [
    "Evaluation",
    "EngineParamsGenerator",
    "MetricEvaluator",
    "MetricEvaluatorResult",
]


class EngineParamsGenerator:
    """Provides the candidate list (reference trait of the same name)."""

    engine_params_list: Sequence[EngineParams] = ()


class Evaluation:
    """Binds an engine with a metric (+ optional extra metrics)
    (reference `Evaluation.scala:66-96` ``engineMetric_=`` sugar)."""

    engine_params_list: Optional[Sequence[EngineParams]] = None

    def __init__(
        self,
        engine: Engine,
        metric: Metric,
        metrics: Sequence[Metric] = (),
        output_path: Optional[str] = "best.json",
        engine_params_list: Optional[Sequence[EngineParams]] = None,
    ):
        self.engine = engine
        self.metric = metric
        self.metrics = list(metrics)
        self.output_path = output_path
        if engine_params_list is not None:
            self.engine_params_list = list(engine_params_list)

    def run(
        self,
        ctx: WorkflowContext,
        engine_params_list: Sequence[EngineParams],
        workflow_params=None,
        parallelism: int = 1,
    ) -> "MetricEvaluatorResult":
        evaluator = MetricEvaluator(
            self.metric, self.metrics, output_path=self.output_path
        )
        return evaluator.evaluate(
            ctx, self.engine, engine_params_list, workflow_params,
            parallelism=parallelism,
        )


@dataclass
class MetricEvaluatorResult:
    """(reference `MetricEvaluator.scala:36-88`)"""

    metric_header: str
    other_metric_headers: list[str]
    best_score: float
    best_engine_params: Optional[EngineParams]
    best_index: int
    # per candidate: (engine_params, score, other_scores)
    results: list[tuple[EngineParams, Any, list[Any]]] = field(
        default_factory=list
    )

    def to_one_liner(self) -> str:
        return f"[{self.best_score}] {self.metric_header}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestScore": self.best_score,
                "bestIndex": self.best_index,
                "bestEngineParams": (
                    _engine_params_json(self.best_engine_params)
                    if self.best_engine_params
                    else None
                ),
                "results": [
                    {
                        "engineParams": _engine_params_json(ep),
                        "score": score,
                        "otherScores": other,
                    }
                    for ep, score, other in self.results
                ],
            },
            indent=2,
        )

    def to_html(self) -> str:
        rows = "\n".join(
            "<tr><td>{}</td><td>{}</td><td><pre>{}</pre></td></tr>".format(
                _html.escape(str(score)),
                _html.escape(json.dumps(other)),
                _html.escape(
                    json.dumps(_engine_params_json(ep), indent=1)
                ),
            )
            for ep, score, other in self.results
        )
        return (
            "<html><body>"
            f"<h3>Best score: {_html.escape(str(self.best_score))} "
            f"({_html.escape(self.metric_header)})</h3>"
            f"<table border='1'><tr><th>{_html.escape(self.metric_header)}"
            f"</th><th>other metrics</th><th>engine params</th></tr>"
            f"{rows}</table></body></html>"
        )


def _engine_params_json(ep: EngineParams) -> dict:
    return {
        "datasource": {
            "name": ep.data_source[0],
            "params": params_to_json(ep.data_source[1]),
        },
        "preparator": {
            "name": ep.preparator[0],
            "params": params_to_json(ep.preparator[1]),
        },
        "algorithms": [
            {"name": n, "params": params_to_json(p)} for n, p in ep.algorithms
        ],
        "serving": {
            "name": ep.serving[0],
            "params": params_to_json(ep.serving[1]),
        },
    }


def _json_safe_score(score):
    """Manifest records are JSON lines; scores are usually floats but
    custom metrics may return anything comparable."""
    try:
        return float(score)
    except (TypeError, ValueError):
        return repr(score)


class MetricEvaluator:
    """Scores every candidate, argmax by ``metric.compare``
    (reference `MetricEvaluator.scala:177-221`)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: Optional[str] = "best.json",
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def _score_one(self, ctx, engine, ep, workflow_params, ix, total):
        t0 = time.perf_counter()
        with phase_span("eval.sweep", attrs={"candidate": ix}):
            eval_out = engine.eval(ctx, ep, workflow_params)
            t1 = time.perf_counter()
            score = self.metric.calculate(ctx, eval_out)
            other = [m.calculate(ctx, eval_out) for m in self.other_metrics]
        t2 = time.perf_counter()
        # the eval run's manifest appends one candidate record per scored
        # candidate: the sweep is replayable from disk
        tower.record_candidate(
            ix,
            score=_json_safe_score(score),
            metric=self.metric.header,
            seconds=round(t2 - t0, 6),
        )
        # streamed from here so the parallel sweep shows live progress too
        logger.info(
            "MetricEvaluator: candidate %d/%d -> %s = %s (%.3f s: eval "
            "%.3f s, metrics %.3f s)",
            ix + 1, total, self.metric.header, score, t2 - t0, t1 - t0,
            t2 - t1,
        )
        return (ep, score, other)

    def evaluate(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        workflow_params=None,
        parallelism: int = 1,
    ) -> MetricEvaluatorResult:
        """Score all candidates; ``parallelism > 1`` runs them from a
        thread pool (the reference's ``.par`` sweep,
        `MetricEvaluator.scala:183-192`).  Device work still serializes on
        the card's stream, but host-side reads/prep/metric math of one
        candidate overlap another's device time, and the kernel library,
        its launch counts and the gather-form resolution are shared
        across threads (built, counted and resolved once).
        Results keep candidate order either way; storage backends and
        dispatch are thread-safe.  Sweeps through a ``FastEvalEngine`` are
        better run sequentially: its prefix cache dedupes shared pipeline
        stages only when candidates arrive in order."""
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        if parallelism > 1:
            from concurrent.futures import ThreadPoolExecutor

            from .fast_eval import FastEvalEngine

            if isinstance(engine, FastEvalEngine):
                raise ValueError(
                    "parallelism > 1 cannot run through a FastEvalEngine "
                    "(its prefix caches are not thread-safe); pass the "
                    "plain Engine, or use run_evaluation which unwraps it"
                )

            total = len(engine_params_list)
            with ThreadPoolExecutor(max_workers=parallelism) as ex:
                results = list(
                    ex.map(
                        lambda ix_ep: self._score_one(
                            ctx, engine, ix_ep[1], workflow_params,
                            ix_ep[0], total,
                        ),
                        enumerate(engine_params_list),
                    )
                )
        else:
            results = [
                self._score_one(
                    ctx, engine, ep, workflow_params, ix,
                    len(engine_params_list),
                )
                for ix, ep in enumerate(engine_params_list)
            ]

        # NaN-safe argmax: a NaN score never beats a finite one, and a
        # finite score always replaces a NaN incumbent (Metric.compare
        # returns -1 for any NaN comparison, which would otherwise let
        # a NaN first candidate win the whole sweep)
        def _is_nan(x) -> bool:
            return isinstance(x, float) and x != x

        best_ix, best_score = -1, None
        for ix, (_, score, _other) in enumerate(results):
            if (
                best_ix < 0
                or (_is_nan(best_score) and not _is_nan(score))
                or (
                    not _is_nan(score)
                    and self.metric.compare(score, best_score) > 0
                )
            ):
                best_ix, best_score = ix, score
        result = MetricEvaluatorResult(
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            best_score=best_score,
            best_engine_params=engine_params_list[best_ix],
            best_index=best_ix,
            results=results,
        )
        if self.output_path:
            self.save_engine_json(result, self.output_path)
        return result

    def save_engine_json(
        self, result: MetricEvaluatorResult, path: str | Path
    ) -> None:
        """Write the winning EngineParams as an engine.json-shaped variant
        (reference `MetricEvaluator.saveEngineJson:152-175`)."""
        ep = result.best_engine_params
        doc = {
            "id": "best",
            "description": f"best params from evaluation "
            f"({result.metric_header}={result.best_score})",
            **_engine_params_json(ep),
        }
        Path(path).write_text(json.dumps(doc, indent=2))
