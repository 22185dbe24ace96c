"""Train and deploy-preparation entry points.

Port of ``predictionio_tpu/workflow/train.py`` (single process):
`CoreWorkflow.runTrain` semantics
(`core/.../workflow/CoreWorkflow.scala:42-94`).  Lifecycle parity: insert
the EngineInstance (INIT) -> TRAINING -> train -> persist models ->
COMPLETED; failures mark the record FAILED (or INTERRUPTED) and re-raise.
``prepare_deploy`` mirrors `Engine.prepareDeploy`
(`controller/Engine.scala:173-243`), including the compat retrain of
models that were not persisted.  A run is observed as the reference
observes it: a pio-tower session writes its run manifest (one record
per sweep, a ``final`` record), ``train.run`` and ``train.save_models``
phase spans, and the device-memory sampler.  The multi-host instance-id
broadcast has no counterpart here.
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
from ..engines import engine_label_of
from ..obs import phase_span, tower, xray
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
    context defaults to the card and the registry's storage.  A
    :class:`~..obs.tower.ConvergenceError` from the watchdog propagates
    with the instance FAILED and the manifest finalized ``aborted``."""
    # build and device observability for the whole run: the sampler
    # keeps the memory gauges live while we train
    xray.install()
    xray.start_sampler()
    ctx = ctx or WorkflowContext(mode="Training")
    wp = workflow_params or WorkflowParams()
    md = ctx.storage.get_metadata()
    instance_id = new_instance_id()
    session = tower.TowerSession(
        instance_id,
        kind="train",
        meta={
            "engineId": engine_id,
            "engine": engine_label_of(engine, fallback=engine_id),
            "engineVariant": engine_variant,
            "batch": wp.batch,
            "nDevices": 1,
        },
    ).start()
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
        t_run = time.perf_counter()
        with phase_span("train.run", attrs={"instance": instance_id}):
            algos, models = engine.train_components(ctx, engine_params, wp)
        session.note_train_run(time.perf_counter() - t_run)
        if wp.save_model:
            names = [n for n, _ in engine_params.algorithms]
            t0 = time.perf_counter()
            with phase_span("train.save_models",
                            attrs={"instance": instance_id}):
                save_models(ctx, instance_id,
                            list(zip(names, algos, models)))
            logger.info("models of instance %s saved: %.3f s", instance_id,
                        time.perf_counter() - t0)
        ei.status = "COMPLETED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        session.finalize("completed")
        logger.info("training finished: instance %s", instance_id)
        return instance_id
    except TrainingInterrupted as e:
        ei.status = "INTERRUPTED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        session.finalize("interrupted", error=str(e))
        raise
    except Exception as e:
        ei.status = "FAILED"
        ei.end_time = format_time(now_utc())
        md.engine_instance_update(ei)
        # a ConvergenceError was already finalized "aborted" by the
        # watchdog (finalize is idempotent); anything else is "failed"
        session.finalize_error(e)
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
