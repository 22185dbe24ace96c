"""Workflow control parameters (copy of ``predictionio_tpu/workflow/params.py``)
(reference `PredictionIO core/src/main/scala/io/prediction/workflow/WorkflowParams.scala:29-42`)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WorkflowParams:
    batch: str = ""
    verbose: int = 2
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    # multi-process: how long non-chief processes wait for the chief's
    # terminal instance-status row after their part of the train (the
    # chief may still be writing the model to shared storage)
    chief_wait_timeout_s: float = 1800.0
