"""Ad-hoc workflow runner (the reference's FakeWorkflow).

Copy of ``predictionio_tpu/workflow/fake.py`` for the port.  Parity with
`core/src/main/scala/io/prediction/workflow/FakeWorkflow.scala:16-91`:
``FakeRun`` lets an arbitrary ``WorkflowContext -> None`` function execute
under the full framework environment — storage resolved, an
EvaluationInstance recorded with lifecycle status — exactly as if it were a
real evaluation.  Used for experiments and smoke scripts (``pio eval
SomeFakeRunObj`` in the reference; ``run_fake(fn)`` here).
"""

from __future__ import annotations

import logging
import traceback
from typing import Callable, Optional

from ..controller.base import WorkflowContext
from ..storage.event import format_time, now_utc
from ..storage.metadata import EvaluationInstance
from .train import new_instance_id

logger = logging.getLogger(__name__)

__all__ = ["FakeRun", "run_fake"]


class FakeRun:
    """Wraps a context function so workflow tooling can run it like an
    evaluation (reference ``FakeRun`` / ``FakeEvaluator``)."""

    def __init__(self, func: Callable[[WorkflowContext], None]):
        self.func = func

    def run(self, ctx: Optional[WorkflowContext] = None) -> str:
        return run_fake(self.func, ctx)


def run_fake(
    func: Callable[[WorkflowContext], None],
    ctx: Optional[WorkflowContext] = None,
) -> str:
    """Execute ``func(ctx)`` under a recorded evaluation instance; returns
    the instance id."""
    ctx = ctx or WorkflowContext(mode="Evaluation")
    md = ctx.storage.get_metadata()
    eval_id = new_instance_id()
    rec = EvaluationInstance(
        id=eval_id,
        status="INIT",
        start_time=format_time(now_utc()),
        end_time="",
        evaluation_class=getattr(func, "__qualname__", repr(func)),
        engine_params_generator_class="",
        batch="FakeRun",
    )
    md.evaluation_instance_insert(rec)
    try:
        rec.status = "EVALUATING"
        md.evaluation_instance_update(rec)
        func(ctx)
        rec.status = "EVALCOMPLETED"
        rec.evaluator_results = "FakeRun completed"
    except Exception:
        rec.status = "EVALFAILED"
        rec.evaluator_results = traceback.format_exc(limit=5)
        raise
    finally:
        rec.end_time = format_time(now_utc())
        md.evaluation_instance_update(rec)
    return eval_id
