"""Train and deploy-preparation entry points.

Port of ``predictionio_tpu/workflow/train.py`` (single process):
`CoreWorkflow.runTrain` semantics
(`core/.../workflow/CoreWorkflow.scala:42-94`).  Lifecycle parity: insert
the EngineInstance (INIT) -> TRAINING -> train -> persist models ->
COMPLETED; failures mark the record FAILED (or INTERRUPTED) and re-raise.
``prepare_deploy`` mirrors `Engine.prepareDeploy`
(`controller/Engine.scala:173-243`), including the compat retrain of
models that were not persisted.  The reference's run log, trace
spans and multi-host instance-id broadcast have no counterpart here.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from typing import Any, Optional

from ..controller.base import TrainingInterrupted, WorkflowContext
from ..controller.engine import Engine, EngineParams
from ..controller.params import params_to_json
from ..storage.event import format_time, now_utc
from ..storage.metadata import EngineInstance
from .model_io import NotPersisted, load_models, save_models
from .params import WorkflowParams

logger = logging.getLogger(__name__)

__all__ = [
    "new_instance_id",
    "prepare_deploy",
    "prepare_deploy_components",
    "run_train",
]


def new_instance_id() -> str:
    return uuid.uuid4().hex[:16]


def _params_json(engine_params: EngineParams) -> dict[str, str]:
    return {
        "data_source_params": json.dumps(
            {engine_params.data_source[0]: params_to_json(engine_params.data_source[1])}
        ),
        "preparator_params": json.dumps(
            {engine_params.preparator[0]: params_to_json(engine_params.preparator[1])}
        ),
        "algorithms_params": json.dumps(
            [{n: params_to_json(p)} for n, p in engine_params.algorithms]
        ),
        "serving_params": json.dumps(
            {engine_params.serving[0]: params_to_json(engine_params.serving[1])}
        ),
    }


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    ctx: Optional[WorkflowContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
    engine_id: str = "default",
    engine_version: str = "1",
    engine_variant: str = "engine.json",
    engine_factory: str = "",
) -> str:
    """Run training end to end; returns the engine instance id.  The
    context defaults to the card and the registry's storage."""
    ctx = ctx or WorkflowContext(mode="Training")
    wp = workflow_params or WorkflowParams()
    md = ctx.storage.get_metadata()
    instance_id = new_instance_id()
    ei = EngineInstance(
        id=instance_id,
        status="INIT",
        start_time=format_time(now_utc()),
        end_time="",
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=wp.batch,
        mesh_conf={"n_devices": 1},
        **_params_json(engine_params),
    )
    md.engine_instance_insert(ei)
    try:
        ei.status = "TRAINING"
        md.engine_instance_update(ei)
        # keep the trained instances: persistence hooks may rely on state
        # the algorithm built during train
        algos, models = engine.train_components(ctx, engine_params, wp)
        if wp.save_model:
            names = [n for n, _ in engine_params.algorithms]
            t0 = time.perf_counter()
            save_models(ctx, instance_id, list(zip(names, algos, models)))
            logger.info("models of instance %s saved: %.3f s", instance_id,
                        time.perf_counter() - t0)
        ei.status = "COMPLETED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        logger.info("training finished: instance %s", instance_id)
        return instance_id
    except TrainingInterrupted:
        ei.status = "INTERRUPTED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        raise
    except Exception:
        ei.status = "FAILED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        raise


def prepare_deploy(
    engine: Engine,
    engine_params: EngineParams,
    instance_id: str,
    ctx: Optional[WorkflowContext] = None,
) -> list[Any]:
    """Load persisted models for serving; retrain any NotPersisted model
    (reference `Engine.prepareDeploy` / `:186-208`)."""
    _, models, _ = prepare_deploy_components(
        engine, engine_params, instance_id, ctx
    )
    return models


def prepare_deploy_components(
    engine: Engine,
    engine_params: EngineParams,
    instance_id: str,
    ctx: Optional[WorkflowContext] = None,
) -> tuple[list[Any], list[Any], Any]:
    """Like :func:`prepare_deploy`, but returns the serving-ready component
    instances too: ``(algorithms, models, serving)``.  Algorithms get the
    serving context attached (``_ctx``) so predict-time event-store reads
    resolve the same storage the deployment uses."""
    ctx = ctx or WorkflowContext(mode="Serving")
    algos = engine._algorithms(engine_params)
    for a in algos:
        a._ctx = ctx
    names = [n for n, _ in engine_params.algorithms]
    models = load_models(ctx, instance_id, list(zip(names, algos)))
    missing = [i for i, m in enumerate(models) if isinstance(m, NotPersisted)]
    if missing:
        logger.warning(
            "models %s of instance %s were not persisted; retraining those",
            missing, instance_id,
        )
        _, retrained = engine.train_components(
            ctx, engine_params, WorkflowParams(save_model=False),
            algo_indices=missing,
        )
        for i, model in zip(missing, retrained):
            models[i] = model
    serving = engine._serving(engine_params)
    return algos, models, serving
