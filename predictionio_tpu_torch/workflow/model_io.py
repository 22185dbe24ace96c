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
scheme, `controller/Engine.scala:260-278`).

A factor model's fold-in deltas (``live/``) are a chain of ``.npz``
links next to the model (:class:`ModelDelta`, :func:`save_model_delta`,
:func:`load_model_delta_chain`) in the reference's format and meta
version, so a chain written by either package loads in the other.

A ``DEVICE_SHARDED`` algorithm's dataclass model is written in the
reference's ``sharded`` format (:func:`_save_sharded`): its numeric
array fields in one ``.npz``, the rest pickled with the class; either
package's files load in the other to the same arrays (the pickle's
module names of the package the port was made from map to the port's
modules of the same path).  In a multi-process run every process
builds the host copies and only the chief (process 0) writes files and
metadata rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np

import torch

from ..controller.base import Algorithm, WorkflowContext
from ..storage.metadata import Model

__all__ = [
    "DELTA_VERSION",
    "ModelDelta",
    "NotPersisted",
    "delta_file_name",
    "list_model_deltas",
    "load_model_delta",
    "load_model_delta_chain",
    "load_models",
    "model_key",
    "save_model_delta",
    "save_models",
]


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


# the port's package; a pickle naming the package it was made from (the
# same name without "_torch") reads as the port's module of that path
_PORT = __name__.split(".")[0]


class _Unpickler(pickle.Unpickler):
    """Unpickles a model file written by either package."""

    def find_class(self, module: str, name: str):
        head, dot, tail = module.partition(".")
        if head + "_torch" == _PORT:
            module = _PORT + dot + tail
        return super().find_class(module, name)


def _load_pickle(path: Path) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _split_array_fields(model: Any):
    """Dataclass model -> ({numeric array fields}, {other fields}), or
    None when it cannot round-trip through ``cls(**fields)`` (not a
    dataclass, or fields outside ``__init__``)."""
    if not dataclasses.is_dataclass(model) or isinstance(model, type):
        return None
    if any(not f.init for f in dataclasses.fields(model)):
        return None
    arrays: dict[str, Any] = {}
    rest: dict[str, Any] = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        # only numeric arrays ride the npz (object arrays would not load
        # under allow_pickle=False)
        if (isinstance(v, np.ndarray) and v.ndim >= 1
                and v.dtype.kind in "biufc"):
            arrays[f.name] = v
        else:
            rest[f.name] = v
    return arrays, rest


def _save_sharded(model: Any, base_dir: Path, key: str,
                  chief: bool = True) -> Optional[dict]:
    """The reference's ``sharded`` format: one ``.npz`` of the array
    fields and the pickled rest; None when the model has no array field
    (the caller pickles it whole).  Only the chief writes."""
    split = _split_array_fields(model)
    if split is None or not split[0]:
        return None
    arrays, rest = split
    npz_name = f"{key}-arrays.npz"
    rest_name = f"{key}-rest.pkl"
    if chief:
        base_dir.mkdir(parents=True, exist_ok=True)
        # uncompressed: f32 factor tables barely deflate, and the
        # compression would be a second or two a save at ML-20M; either
        # package's np.load reads both forms
        np.savez(base_dir / npz_name, **arrays)
        with open(base_dir / rest_name, "wb") as f:
            pickle.dump({"cls": type(model), "fields": _to_host(rest)}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
    # the host tables of a sharded train are whole (the trainer gathers
    # them), so every array is recorded replicated
    return {"kind": "sharded", "npz": npz_name, "rest": rest_name,
            "specs": {k: None for k in arrays}}


def _load_sharded(manifest: dict, base_dir: Path) -> Any:
    """Rebuild a ``sharded``-format model (written by either package)."""
    rest = _load_pickle(base_dir / manifest["rest"])
    kw = dict(rest["fields"])
    with np.load(base_dir / manifest["npz"], allow_pickle=False) as data:
        for k in data.files:
            kw[k] = data[k]
    return rest["cls"](**kw)


def _place(model: Any, device: torch.device) -> Any:
    """Put a loaded model on the deploying device: a dataclass model
    with a ``device`` field gets the context's device."""
    if dataclasses.is_dataclass(model) and any(
            f.name == "device" for f in dataclasses.fields(model)):
        return dataclasses.replace(model, device=device)
    return model


# --------------------------------------------------------------------------
# Delta model format (pio-live): a versioned chain of row-level patches
# against the last FULL checkpoint of a factor model.  Each delta is one
# atomically-written .npz holding patched factor rows, appended rows with
# their new entity ids, and a JSON meta blob carrying the chain links
# (seq, prev seq, instance, watermark).  The serving layer applies deltas
# in sequence without a stop-the-world reload; a torn or missing link
# truncates the chain at the last good delta — falling back toward the
# full model, never past it (the same contract as StepCheckpointer's
# torn-newest-step fallback).
# --------------------------------------------------------------------------

DELTA_VERSION = 1

_DELTA_RE = re.compile(r"-delta-(\d{8})\.npz$")


@dataclasses.dataclass
class ModelDelta:
    """One link of a delta chain.

    Row indices address the table AS OF the previous link (the full
    model for seq 1): appended rows land at ``base_n_*`` onward, so a
    chain is only applicable in contiguous seq order.
    """

    seq: int
    meta: dict
    user_rows_ix: np.ndarray   # int32 [p] rows patched in the user table
    user_rows: np.ndarray      # f32 [p, R]
    new_user_ids: np.ndarray   # unicode [a] appended user ids
    new_user_rows: np.ndarray  # f32 [a, R]
    item_rows_ix: np.ndarray   # int32 [q] rows patched in the item table
    item_rows: np.ndarray      # f32 [q, R]
    new_item_ids: np.ndarray   # unicode [b] appended item ids
    new_item_rows: np.ndarray  # f32 [b, R]

    @property
    def watermark(self) -> Optional[dict]:
        return self.meta.get("watermark")

    def counts(self) -> dict:
        return {
            "patchedUsers": int(len(self.user_rows_ix)),
            "appendedUsers": int(len(self.new_user_ids)),
            "patchedItems": int(len(self.item_rows_ix)),
            "appendedItems": int(len(self.new_item_ids)),
        }


def delta_file_name(key: str, seq: int) -> str:
    return f"{key}-delta-{seq:08d}.npz"


def save_model_delta(
    base_dir: Path, key: str, delta: ModelDelta
) -> Path:
    """Write one delta link atomically (tmp + rename): a reader either
    sees the previous chain or the complete new link, never a torn
    file — a crash mid-write leaves only a ``.tmp`` orphan that the
    chain loader ignores."""
    base_dir = Path(base_dir)
    base_dir.mkdir(parents=True, exist_ok=True)
    meta = dict(delta.meta)
    meta.setdefault("version", DELTA_VERSION)
    meta["seq"] = int(delta.seq)
    path = base_dir / delta_file_name(key, delta.seq)
    tmp = path.with_suffix(".npz.tmp")
    rank_arrays = {
        "user_rows_ix": np.asarray(delta.user_rows_ix, np.int32),
        "user_rows": np.asarray(delta.user_rows, np.float32),
        "new_user_rows": np.asarray(delta.new_user_rows, np.float32),
        "item_rows_ix": np.asarray(delta.item_rows_ix, np.int32),
        "item_rows": np.asarray(delta.item_rows, np.float32),
        "new_item_rows": np.asarray(delta.new_item_rows, np.float32),
        # unicode ('U') arrays round-trip under allow_pickle=False;
        # object arrays would not
        "new_user_ids": np.asarray(
            [str(s) for s in delta.new_user_ids], dtype=np.str_
        ),
        "new_item_ids": np.asarray(
            [str(s) for s in delta.new_item_ids], dtype=np.str_
        ),
        "meta_json": np.asarray(
            json.dumps(meta, separators=(",", ":"))
        ),
    }
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **rank_arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_model_delta(path: Path) -> ModelDelta:
    """Load one delta link; raises on a torn/truncated/foreign file
    (the chain loader turns that into a clean truncation)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta_json"]))
        if int(meta.get("version", -1)) > DELTA_VERSION:
            raise ValueError(
                f"delta {path.name} has version {meta.get('version')}, "
                f"newer than this framework's {DELTA_VERSION}"
            )
        return ModelDelta(
            seq=int(meta["seq"]),
            meta=meta,
            user_rows_ix=data["user_rows_ix"],
            user_rows=data["user_rows"],
            new_user_ids=data["new_user_ids"],
            new_user_rows=data["new_user_rows"],
            item_rows_ix=data["item_rows_ix"],
            item_rows=data["item_rows"],
            new_item_ids=data["new_item_ids"],
            new_item_rows=data["new_item_rows"],
        )


def list_model_deltas(base_dir: Path, key: str) -> list[tuple[int, Path]]:
    """(seq, path) pairs of the on-disk chain for ``key``, seq-sorted.
    ``.tmp`` orphans from crashed writes never match."""
    base_dir = Path(base_dir)
    if not base_dir.is_dir():
        return []
    out = []
    prefix = f"{key}-delta-"
    for p in base_dir.iterdir():
        if not p.name.startswith(prefix):
            continue
        m = _DELTA_RE.search(p.name)
        if m:
            out.append((int(m.group(1)), p))
    out.sort()
    return out


def load_model_delta_chain(
    base_dir: Path, key: str, after_seq: int = 0
) -> tuple[list["ModelDelta"], Optional[str]]:
    """Load the applicable chain suffix: every delta with ``seq >
    after_seq``, in order, stopping at the first gap or unreadable
    link.

    Returns ``(deltas, error)``.  ``error`` is None for a clean chain;
    otherwise a human-readable reason for the truncation.  A truncated
    chain is NOT a failure mode for the caller — applying the good
    prefix (possibly empty) falls back toward the last full model,
    which is the stale-model-beats-no-model contract serving already
    has for failed reloads.  Appended-row indices make out-of-order or
    gapped application corrupting, so a gap truncates just like a torn
    file.
    """
    out: list[ModelDelta] = []
    err: Optional[str] = None
    expect = int(after_seq) + 1
    for seq, path in list_model_deltas(base_dir, key):
        if seq <= after_seq:
            continue
        if seq != expect:
            err = (
                f"delta chain gap: expected seq {expect}, found "
                f"{path.name}; applying only the contiguous prefix"
            )
            break
        try:
            out.append(load_model_delta(path))
        except Exception as e:
            err = (
                f"delta {path.name} is unreadable "
                f"({type(e).__name__}: {e}); falling back to the "
                f"chain before it"
            )
            break
        expect += 1
    return out, err


def save_models(
    ctx: WorkflowContext,
    instance_id: str,
    algo_tuples: list[tuple[str, Algorithm, Any]],
) -> None:
    """Persist every algorithm's model; the manifest goes into the
    metadata store's models table.  A ``DEVICE_SHARDED`` algorithm's
    model is written in the ``sharded`` format.  In a multi-process run
    only the chief writes files and rows (custom ``save_model`` hooks
    run everywhere and gate their own writes); the others learn that the
    files exist from the chief's terminal instance row."""
    from ..controller.base import ModelPlacement
    from ..parallel.mesh import process_index

    chief = process_index() == 0
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
                manifest = None
                if algo.placement is ModelPlacement.DEVICE_SHARDED:
                    manifest = _save_sharded(model, base_dir, key,
                                             chief=chief)
                if manifest is None:
                    fname = f"model_{ax}_{name or 'default'}.pkl"
                    if chief:
                        base_dir.mkdir(parents=True, exist_ok=True)
                        with open(base_dir / fname, "wb") as f:
                            pickle.dump(_to_host(model), f,
                                        protocol=pickle.HIGHEST_PROTOCOL)
                    # the name is relative to base_dir so the storage
                    # tree can be relocated between train and deploy
                    manifest = {"kind": "pickle", "file": fname}
        if chief:
            md.model_insert(
                Model(id=key, models=json.dumps(manifest).encode()))


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
            out.append(_place(_load_pickle(path), ctx.device))
        elif kind == "sharded":
            out.append(_place(_load_sharded(manifest, base_dir),
                              ctx.device))
        else:
            raise ValueError(f"unknown model manifest kind: {kind!r}")
    return out
