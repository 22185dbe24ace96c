"""Model persistence: pickled host models behind a manifest in the metadata
store.

Port of ``predictionio_tpu/workflow/model_io.py`` (single process).  It
replaces the reference's Kryo-blob path (`workflow/CoreWorkflow.scala:
69-74`, `storage/Models.scala:30-48`) and the `PersistentModel` contract
(`controller/PersistentModel.scala:48-95`):

* every model is persisted by default; an algorithm that sets
  ``persist_model = False`` is written as ``not_persisted`` and retrained
  at deploy (the reference's compat path);
* a model is pickled with its torch tensors moved to the host, and a
  dataclass model keeps only its fields (device-resident caches such as
  the serving table are rebuilt on first use); at load, a model with a
  ``device`` field is placed on the deploying context's device;
* algorithms may override ``save_model``/``load_model`` for custom formats.

The metadata ``models`` table stores the manifest JSON keyed by
``<instance_id>-<algo_ix>-<algo_name>`` (:func:`model_key`, the reference's
scheme, `controller/Engine.scala:260-278`).  The reference's sharded
``.npz`` format for ``DEVICE_SHARDED`` models and its fold-in delta chains
are not ported yet: the port writes the ``pickle`` kind for every
persisted model and refuses to load a ``sharded`` manifest.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Any

import torch

from ..controller.base import Algorithm, WorkflowContext
from ..storage.metadata import Model

__all__ = ["NotPersisted", "load_models", "model_key", "save_models"]


class NotPersisted:
    """Marker: model was not persisted; deploy must retrain
    (reference `controller/Engine.scala:186-208`)."""


def model_key(instance_id: str, ax: int, name: str) -> str:
    return "-".join([instance_id, str(ax), name])


def _to_host(v: Any) -> Any:
    """Torch tensors -> CPU tensors, recursively through lists, tuples
    and dicts; a dataclass model is rebuilt from its fields alone."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if all(f.init for f in dataclasses.fields(v)):
            return type(v)(**{
                f.name: _to_host(getattr(v, f.name))
                for f in dataclasses.fields(v)
            })
        return v
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _place(model: Any, device: torch.device) -> Any:
    """Put a loaded model on the deploying device: a dataclass model
    with a ``device`` field gets the context's device."""
    if dataclasses.is_dataclass(model) and any(
            f.name == "device" for f in dataclasses.fields(model)):
        return dataclasses.replace(model, device=device)
    return model


def save_models(
    ctx: WorkflowContext,
    instance_id: str,
    algo_tuples: list[tuple[str, Algorithm, Any]],
) -> None:
    """Persist every algorithm's model; the manifest goes into the
    metadata store's models table."""
    md = ctx.storage.get_metadata()
    base_dir = ctx.storage.model_data_dir() / instance_id
    for ax, (name, algo, model) in enumerate(algo_tuples):
        key = model_key(instance_id, ax, name)
        if not algo.persist_model:
            manifest = {"kind": "not_persisted"}
        else:
            custom = algo.save_model(ctx, key, model, base_dir)
            if custom is not None:
                manifest = {"kind": "custom", "custom": custom}
            else:
                fname = f"model_{ax}_{name or 'default'}.pkl"
                base_dir.mkdir(parents=True, exist_ok=True)
                with open(base_dir / fname, "wb") as f:
                    pickle.dump(_to_host(model), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                # the name is relative to base_dir so the storage tree
                # can be relocated between train and deploy hosts
                manifest = {"kind": "pickle", "file": fname}
        md.model_insert(Model(id=key, models=json.dumps(manifest).encode()))


def load_models(
    ctx: WorkflowContext,
    instance_id: str,
    algo_tuples: list[tuple[str, Algorithm]],
) -> list[Any]:
    """Load (or mark-for-retrain) each algorithm's model for deployment."""
    md = ctx.storage.get_metadata()
    base_dir = ctx.storage.model_data_dir() / instance_id
    out: list[Any] = []
    for ax, (name, algo) in enumerate(algo_tuples):
        key = model_key(instance_id, ax, name)
        rec = md.model_get(key)
        if rec is None:
            out.append(NotPersisted())
            continue
        manifest = json.loads(rec.models.decode())
        kind = manifest.get("kind")
        if kind == "not_persisted":
            out.append(NotPersisted())
        elif kind == "custom":
            out.append(algo.load_model(ctx, key, manifest["custom"], base_dir))
        elif kind == "pickle":
            path = (
                base_dir / manifest["file"]
                if "file" in manifest
                else Path(manifest["path"])
            )
            with open(path, "rb") as f:
                out.append(_place(pickle.load(f), ctx.device))
        elif kind == "sharded":
            raise NotImplementedError(
                f"model {key} was saved in the sharded .npz format, which "
                "is not ported to predictionio_tpu_torch yet (ROADMAP "
                "Queue 1)"
            )
        else:
            raise ValueError(f"unknown model manifest kind: {kind!r}")
    return out
