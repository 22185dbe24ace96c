"""Workflow layer of the port: the train and deploy entry points, model
persistence and workflow parameters (single process)."""

from .model_io import NotPersisted, load_models, save_models
from .params import WorkflowParams
from .train import prepare_deploy, prepare_deploy_components, run_train

__all__ = [
    "NotPersisted",
    "WorkflowParams",
    "load_models",
    "prepare_deploy",
    "prepare_deploy_components",
    "run_train",
    "save_models",
]
