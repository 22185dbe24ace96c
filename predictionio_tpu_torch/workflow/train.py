"""Train and deploy-preparation entry points.

Port of ``predictionio_tpu/workflow/train.py``:
`CoreWorkflow.runTrain` semantics
(`core/.../workflow/CoreWorkflow.scala:42-94`).  Lifecycle parity: insert
the EngineInstance (INIT) -> TRAINING -> train -> persist models ->
COMPLETED; failures mark the record FAILED (or INTERRUPTED) and re-raise.
``prepare_deploy`` mirrors `Engine.prepareDeploy`
(`controller/Engine.scala:173-243`), including the compat retrain of
models that were not persisted.  A run is observed as the reference
observes it: a pio-tower session writes its run manifest (one record
per sweep, a ``final`` record), ``train.run`` and ``train.save_models``
phase spans, and the device-memory sampler.

In a multi-process run (``parallel.mesh.distributed_init``) every
process runs the same train: the chief (process 0) draws the instance
id and broadcasts it, only the chief writes the instance and model rows,
every worker stamps its spans with its index and publishes its registry
snapshots into ``PIO_TPU_COORD_DIR`` for the chief's tower session, and
a non-chief that finished waits for the chief's terminal row.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Any, Optional

from ..controller.base import TrainingInterrupted, WorkflowContext
from ..controller.engine import Engine, EngineParams
from ..controller.params import params_to_json
from ..engines import engine_label_of
from ..obs import get_tracer, phase_span, tower, xray
from ..parallel.mesh import process_count, process_index
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


def _shared_instance_id() -> str:
    """One instance id for the whole (possibly multi-process) run: the
    chief draws it, the others receive it by broadcast."""
    iid = new_instance_id()
    if process_count() > 1:
        import torch.distributed as dist

        box = [iid]
        dist.broadcast_object_list(box, src=0)
        iid = box[0]
    return iid


def _await_chief_terminal_status(
    md, instance_id: str, timeout: float = 1800.0
) -> None:
    """A non-chief's wait for the chief's terminal instance status in
    the shared metadata store (not a collective: one could pair out of
    order with a collective inside a failing peer's train and hang).
    Raises if the chief recorded a failure or never wrote a terminal
    row."""
    deadline = time.time() + timeout
    while True:
        rec = md.engine_instance_get(instance_id)
        status = rec.status if rec is not None else "MISSING"
        if status == "COMPLETED":
            return
        if status in ("FAILED", "INTERRUPTED"):
            raise RuntimeError(
                f"training {status.lower()} on the chief process "
                f"(instance {instance_id})"
            )
        if time.time() > deadline:
            raise TimeoutError(
                f"chief process never recorded a terminal status for "
                f"instance {instance_id} (last seen: {status}) within "
                f"{timeout}s"
            )
        time.sleep(0.05)


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
    n_proc = process_count()
    chief = process_index() == 0
    if n_proc > 1:
        # a cluster run's span journals merge and grep by worker
        get_tracer().set_process_index(process_index())
    instance_id = _shared_instance_id()
    n_devices = ctx.mesh.size if n_proc > 1 else 1
    session = tower.TowerSession(
        instance_id,
        kind="train",
        meta={
            "engineId": engine_id,
            "engine": engine_label_of(engine, fallback=engine_id),
            "engineVariant": engine_variant,
            "batch": wp.batch,
            "nDevices": n_devices,
        },
        worker=process_index(),
        n_workers=n_proc,
        coord_dir=os.environ.get("PIO_TPU_COORD_DIR"),
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
        mesh_conf={"n_devices": n_devices},
        **_params_json(engine_params),
    )
    if chief:
        md.engine_instance_insert(ei)
    completed = False
    try:
        ei.status = "TRAINING"
        if chief:
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
        if chief:
            md.engine_instance_update(ei)
        completed = True
        session.finalize("completed")
        logger.info("training finished: instance %s", instance_id)
        return instance_id
    except TrainingInterrupted as e:
        ei.status = "INTERRUPTED"
        ei.end_time = format_time(now_utc())
        if chief:
            md.engine_instance_update(ei)
        session.finalize("interrupted", error=str(e))
        raise
    except Exception as e:
        ei.status = "FAILED"
        ei.end_time = format_time(now_utc())
        if chief:
            md.engine_instance_update(ei)
        # a ConvergenceError was already finalized "aborted" by the
        # watchdog (finalize is idempotent); anything else is "failed"
        session.finalize_error(e)
        raise
    finally:
        if n_proc > 1 and not chief and completed:
            # the chief's terminal row is the verdict, and orders its
            # model files before any process returns or deploys
            _await_chief_terminal_status(
                md, instance_id, timeout=wp.chief_wait_timeout_s)


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
