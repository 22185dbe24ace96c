"""Workflow control parameters (copy of ``predictionio_tpu/workflow/params.py``
without the multi-host wait, which the single-device port has no use for)
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
