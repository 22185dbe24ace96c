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
version, so a chain written by either package loads in the other.  The
reference's sharded ``.npz`` format for ``DEVICE_SHARDED`` models is not
ported yet: the port writes the ``pickle`` kind for every persisted
model and refuses to load a ``sharded`` manifest.
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
