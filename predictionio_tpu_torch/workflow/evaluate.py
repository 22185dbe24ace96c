"""The evaluation workflow's entry point.

Port of ``predictionio_tpu/workflow/evaluate.py``:
`CoreWorkflow.runEvaluation` semantics
(`core/src/main/scala/io/prediction/workflow/CoreWorkflow.scala:96-150`
+ `EvaluationWorkflow.scala:29-42`): insert an EvaluationInstance, run the
sweep, record one-liner/HTML/JSON renderings for the dashboard, mark
EVALCOMPLETED.  The run is an ``eval.run`` phase span and a pio-tower
session of kind ``eval``, whose manifest holds one record per candidate.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from ..controller.base import WorkflowContext
from ..controller.engine import Engine, EngineParams
from ..controller.evaluation import Evaluation, MetricEvaluatorResult
from ..controller.fast_eval import FastEvalEngine
from ..obs import phase_span, tower
from ..storage.event import format_time, now_utc
from ..storage.metadata import EvaluationInstance
from .params import WorkflowParams
from .train import new_instance_id

logger = logging.getLogger(__name__)

__all__ = ["NO_CANDIDATES", "run_evaluation"]

NO_CANDIDATES = (
    "no engine params candidates: pass engine_params_list, set "
    ".engine_params_list on the Evaluation, or supply an "
    "EngineParamsGenerator"
)


def run_evaluation(
    evaluation: Evaluation,
    engine_params_list: Optional[Sequence[EngineParams]] = None,
    ctx: Optional[WorkflowContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
    evaluation_class: str = "",
    engine_params_generator_class: str = "",
    fast_eval: bool = True,
    parallelism: int = 1,
) -> tuple[str, MetricEvaluatorResult]:
    """Run the sweep; returns (evaluation instance id, result).  The
    context defaults to the card and the registry's storage.

    ``parallelism > 1`` scores candidates from a thread pool and implies
    ``fast_eval=False`` (FastEval's prefix cache dedupes shared pipeline
    stages only for in-order candidates — running both would re-compute
    the prefixes it exists to save)."""
    if parallelism > 1:
        fast_eval = False
    ctx = ctx or WorkflowContext(mode="Evaluation")
    wp = workflow_params or WorkflowParams()
    md = ctx.storage.get_metadata()

    if engine_params_list is None:
        # resolve BEFORE inserting the instance record so a missing candidate
        # list fails cleanly instead of leaving a stuck INIT record
        candidates = getattr(evaluation, "engine_params_list", None)
        if candidates is None:
            raise ValueError(NO_CANDIDATES)
        engine_params_list = list(candidates)

    eval_id = new_instance_id()
    rec = EvaluationInstance(
        id=eval_id,
        status="INIT",
        start_time=format_time(now_utc()),
        end_time="",
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=engine_params_generator_class,
        batch=wp.batch,
    )
    md.evaluation_instance_insert(rec)

    try:
        rec.status = "EVALUATING"
        md.evaluation_instance_update(rec)
        engine = evaluation.engine
        if parallelism > 1 and isinstance(engine, FastEvalEngine):
            # FastEval's check-then-insert prefix caches are not
            # thread-safe; a pre-wrapped engine must be unwrapped, not
            # just the auto-wrap skipped
            engine = Engine(
                engine.data_source_class_map,
                engine.preparator_class_map,
                engine.algorithm_class_map,
                engine.serving_class_map,
            )
            evaluation = Evaluation(
                engine, evaluation.metric, evaluation.metrics,
                evaluation.output_path,
            )
        elif fast_eval and not isinstance(engine, FastEvalEngine):
            engine = FastEvalEngine(engine)
            evaluation = Evaluation(
                engine, evaluation.metric, evaluation.metrics,
                evaluation.output_path,
            )
        session = tower.TowerSession(
            eval_id,
            kind="eval",
            meta={
                "evaluationClass": rec.evaluation_class,
                "candidates": len(engine_params_list),
                "batch": wp.batch,
            },
        ).start()
        try:
            with phase_span("eval.run", attrs={
                "instance": eval_id, "candidates": len(engine_params_list),
            }):
                result = evaluation.run(
                    ctx, engine_params_list, wp, parallelism=parallelism
                )
            session.finalize("completed")
        except BaseException as e:
            session.finalize_error(e)
            raise
        rec.status = "EVALCOMPLETED"
        rec.end_time = format_time(now_utc())
        rec.evaluator_results = result.to_one_liner()
        rec.evaluator_results_html = result.to_html()
        rec.evaluator_results_json = result.to_json()
        md.evaluation_instance_update(rec)
        return eval_id, result
    except Exception:
        rec.status = "EVALFAILED"
        rec.end_time = format_time(now_utc())
        md.evaluation_instance_update(rec)
        raise
