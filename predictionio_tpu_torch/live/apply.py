"""Apply a persisted model delta to an in-memory factor model.

Port of ``predictionio_tpu/live/apply.py``.  Shared by the serving
update path (`server/serving.py` applies deltas under its state lock,
no stop-the-world reload) and the fold-in daemon (which applies its own
deltas so consecutive cycles compose).

Tear-freedom without a reader lock: every mutation is published as ONE
attribute rebind (``model.user_factors = new_array``), and the id maps
only grow (``StringIndex.append``), so a concurrent scorer sees either
the old table or the new one — mixed reads are safe because new rows
are strictly additive and patched rows are newer values of the same
row.  The cached device tables (the serve-time top-k index) are patched
row-wise through ``DeviceTableMixin.patch_device_item_rows`` instead of
being dropped, so the first post-delta query pays no full re-upload,
and so are the two-stage retrievers' quantized indexes
(``DeviceTableMixin.patch_ann_indexes``: the touched rows re-quantized,
new items appended to their nearest coarse cluster, no rebuild).
"""

from __future__ import annotations

import logging

import numpy as np

from ..workflow.model_io import ModelDelta

logger = logging.getLogger(__name__)

__all__ = ["apply_model_delta", "model_supports_deltas"]


def model_supports_deltas(model) -> bool:
    """Whether a model object has the factor-table shape deltas patch
    (the recommendation-family ALS models)."""
    return all(
        hasattr(model, a)
        for a in ("user_factors", "item_factors", "users", "items")
    ) and hasattr(model.users, "append")


def apply_model_delta(model, delta: ModelDelta) -> dict:
    """Patch ``model`` in place with one delta link; returns the counts
    dict.  Raises ``ValueError`` when the delta's recorded base table
    sizes don't match the model — an out-of-order or double apply must
    fail loudly, not corrupt row indexing."""
    meta = delta.meta
    base_users = meta.get("baseUsers")
    base_items = meta.get("baseItems")
    if base_users is not None and int(base_users) != len(model.users):
        raise ValueError(
            f"delta seq {delta.seq} expects a user table of "
            f"{base_users} rows, model has {len(model.users)} "
            "(chain applied out of order?)"
        )
    if base_items is not None and int(base_items) != len(model.items):
        raise ValueError(
            f"delta seq {delta.seq} expects an item table of "
            f"{base_items} rows, model has {len(model.items)}"
        )

    def grown(table: np.ndarray, ixs, rows, appended) -> np.ndarray:
        ixs = np.asarray(ixs, np.int64)
        if len(ixs) == 0 and len(appended) == 0:
            return table
        if len(appended):
            new = np.concatenate(
                [np.asarray(table), np.asarray(appended, table.dtype)],
                axis=0,
            )
        else:
            new = np.array(table, copy=True)
        if len(ixs):
            new[ixs] = np.asarray(rows, new.dtype)
        return new

    new_uf = grown(
        model.user_factors, delta.user_rows_ix, delta.user_rows,
        delta.new_user_rows,
    )
    new_if = grown(
        model.item_factors, delta.item_rows_ix, delta.item_rows,
        delta.new_item_rows,
    )
    # publish rows BEFORE ids: extra table rows nothing resolves to are
    # harmless, but an id resolving before its row exists would index
    # out of bounds in a concurrent scorer
    model.user_factors = new_uf
    model.item_factors = new_if
    # the device-resident top-k index: patch cached tables row-wise
    patch = getattr(model, "patch_device_item_rows", None)
    item_ixs = np.asarray(delta.item_rows_ix, np.int32)
    if patch is not None:
        patch(item_ixs, delta.item_rows, delta.new_item_rows)
    # the quantized retrieval indexes are serve-time state like the
    # device tables: re-quantize only the delta's rows and append new
    # items to their nearest coarse cluster, in place
    patch_ann = getattr(model, "patch_ann_indexes", None)
    counts = delta.counts()
    if patch_ann is not None:
        counts["annIndexesPatched"] = patch_ann(
            item_ixs, delta.item_rows, delta.new_item_rows
        )
    model.users.append([str(s) for s in delta.new_user_ids])
    model.items.append([str(s) for s in delta.new_item_ids])
    return counts
