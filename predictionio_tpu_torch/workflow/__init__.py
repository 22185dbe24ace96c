"""Workflow layer of the port: the train, deploy and evaluation entry
points, model persistence and workflow parameters (single process)."""

from .evaluate import run_evaluation
from .fake import FakeRun, run_fake
from .model_io import NotPersisted, load_models, save_models
from .params import WorkflowParams
from .train import prepare_deploy, prepare_deploy_components, run_train

__all__ = [
    "FakeRun",
    "NotPersisted",
    "WorkflowParams",
    "load_models",
    "prepare_deploy",
    "prepare_deploy_components",
    "run_evaluation",
    "run_fake",
    "run_train",
    "save_models",
]
