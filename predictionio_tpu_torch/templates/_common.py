"""Shared template helpers (port of ``predictionio_tpu/templates/_common.py``:
the train-time row normalization, the device table caches and their
fold-in patch, the two-stage retrievers cached beside them, the query
filter mask, the batch ladder and the batched scorer warm-up)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["DeviceTableMixin", "filter_bias_mask", "normalize_rows",
           "pow2_ladder", "warm_batched_topk"]


def normalize_rows(table: np.ndarray) -> np.ndarray:
    """Row-normalize a factor table in f32, the train-time step of the
    normalized-table cosine engines (similarproduct, itemsimilarity):
    inner product over the stored table is cosine, so the exact scorer
    and the two-stage retrievers serve cosine with no per-query
    normalization.  A zero row (an item nobody viewed) stays zero and
    scores 0."""
    t = np.asarray(table, np.float32)
    return t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-9)


def _as_table(rows: np.ndarray, like: torch.Tensor,
              axis: int) -> torch.Tensor:
    """Host ``[n, R]`` rows on ``like``'s device and dtype, as columns
    (``[R, n]``) when ``axis`` is 1."""
    t = torch.as_tensor(rows, device=like.device).to(like.dtype)
    return t.T.contiguous() if axis else t


class DeviceTableMixin:
    """Lazy one-time host->device transfer of the model's item factor
    table, cached on the model instance: every scoring call reuses the
    device-resident tensors.  The host class provides ``item_factors``
    and ``device``.

    ``dtype`` lets serving trade precision for memory bandwidth
    (``"bfloat16"`` halves the bytes each scoring product reads, at a
    ranking-only precision cost); each dtype is cached separately."""

    def _cached_device(self, key: str, make) -> torch.Tensor:
        dev = getattr(self, key, None)
        if dev is None:
            dev = make()
            setattr(self, key, dev)
        return dev

    def device_item_factors(self, dtype: Optional[str] = None):
        def make():
            t = torch.as_tensor(np.asarray(self.item_factors, np.float32),
                                device=self.device)
            return t.to(getattr(torch, dtype)) if dtype else t

        return self._cached_device(
            f"_dev_item_factors_{dtype or 'native'}", make
        )

    def patch_device_item_rows(
        self, ixs, rows, appended: Optional[np.ndarray] = None
    ) -> None:
        """pio-live delta apply: patch every CACHED device item table
        (row writes and appends) instead of dropping the caches and
        re-uploading the whole table on the next query.

        The device tables are the serve-time top-k index (every query's
        score product reads them), so this is what makes a fold-in
        visible to predictions without a reload.  The transposed
        ``[R, M]`` serving layout gets its patched rows as column writes
        and its appended rows as appended columns.  Each table is built
        anew on its device and swapped in with one attribute rebind, so
        a concurrent reader sees the old table or the new one, never a
        torn row; caches that do not exist yet are left absent (they are
        built from the already-patched host table on first use).
        Normalized tables get their rows normalized in f32 first, as
        :meth:`device_item_factors_normalized` builds them."""
        if len(ixs) == 0 and (appended is None or len(appended) == 0):
            return
        rows_np = np.asarray(rows, np.float32)
        app_np = (
            np.asarray(appended, np.float32)
            if appended is not None and len(appended) else None
        )
        def norm(a: np.ndarray) -> np.ndarray:
            return a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9)

        for attr in list(vars(self)):
            dev = getattr(self, attr)
            if not attr.startswith("_dev_item_factors_") or dev is None:
                continue
            normed = attr.startswith("_dev_item_factors_norm_")
            src_rows = norm(rows_np) if normed else rows_np
            src_app = (norm(app_np) if normed and app_np is not None
                       else app_np)
            # the [R, M] layout takes rows as columns
            axis = 1 if attr.startswith("_dev_item_factors_t_") else 0
            new = (torch.cat([dev, _as_table(src_app, dev, axis)], dim=axis)
                   if src_app is not None else dev.clone())
            if len(rows_np):
                ix = torch.as_tensor(np.asarray(ixs, np.int64),
                                     device=dev.device)
                new.index_copy_(axis, ix, _as_table(src_rows, dev, axis))
            setattr(self, attr, new)

    def device_item_factors_t(self, dtype: Optional[str] = None):
        """The item table pre-transposed to ``[R, M]`` (contiguous), the
        layout of the batched serving product
        (``ops.topk.batch_topk_scores_t``).  Cached per dtype."""

        def make():
            return self.device_item_factors(dtype).T.contiguous()

        return self._cached_device(
            f"_dev_item_factors_t_{dtype or 'native'}", make
        )

    def device_ann_index(self, cfg):
        """The two-stage retriever for ``cfg`` (a
        ``retrieval.RetrievalConfig``), built once per model (re)load on
        the model's device and cached per config like the device
        tables; fold-in deltas patch it in place
        (:meth:`patch_ann_indexes`)."""
        from ..retrieval import TwoStageRetriever

        key = f"_ann_index_{cfg.cache_key()}"
        idx = getattr(self, key, None)
        if idx is None:
            idx = TwoStageRetriever.build(self.item_factors, cfg,
                                          device=self.device)
            setattr(self, key, idx)
        return idx

    def patch_ann_indexes(self, ixs, rows, appended=None) -> int:
        """Fold-in delta apply: fold the touched and appended item rows
        into every cached retriever in place (re-quantize those rows,
        append new items to their nearest coarse cluster), so
        two-stage predictions advance with the exact ones.  Returns the
        number of indexes patched."""
        n = 0
        for attr in list(vars(self)):
            if attr.startswith("_ann_index_"):
                getattr(self, attr).patch(ixs, rows, appended)
                n += 1
        return n

    def device_item_factors_normalized(self, dtype: Optional[str] = None):
        """Row-normalized table for cosine scoring, normalized once (in
        f32, then cast), not per request."""

        def make():
            table = self.device_item_factors()
            dev = table / (torch.linalg.vector_norm(
                table, dim=-1, keepdim=True) + 1e-9)
            return dev.to(getattr(torch, dtype)) if dtype else dev

        return self._cached_device(
            f"_dev_item_factors_norm_{dtype or 'native'}", make
        )


def filter_bias_mask(
    items,
    item_props: Optional[dict] = None,
    *,
    categories=None,
    whitelist=None,
    blacklist=(),
    exclude_ix=(),
    none_if_empty: bool = False,
):
    """Additive -inf bias over the item table for query-side filtering
    (filter-by-category / whitelist / blacklist, plus query-item
    exclusion).  ``none_if_empty=True`` returns None when no filter is
    active so callers can dispatch the unbiased scorer."""
    ex = tuple(exclude_ix)  # materialize ONCE: one-shot iterables
    has_filter = bool(categories or whitelist or blacklist or ex)
    if none_if_empty and not has_filter:
        return None
    n = len(items)
    allowed = np.ones(n, dtype=bool)
    if ex:
        allowed[list(ex)] = False
    if whitelist:
        allowed &= np.isin(items.ids.astype(str),
                           np.array(sorted(whitelist), dtype=str))
    if categories:
        cats = set(categories)
        has = np.zeros(n, dtype=bool)
        for item_id, props in (item_props or {}).items():
            ix = items.get(item_id)
            if ix >= 0 and cats & set(props.get("categories", [])):
                has[ix] = True
        allowed &= has
    if blacklist:
        allowed &= ~np.isin(items.ids.astype(str),
                            np.array(sorted(blacklist), dtype=str))
    return np.where(allowed, 0.0, -np.inf).astype(np.float32)


def pow2_ladder(max_batch: int) -> list[int]:
    """Every batch size a pow2-padding micro-batcher with this
    ``max_batch`` can dispatch: 1, 2, 4, ... up to the pow2 ceiling of
    ``max_batch`` (the reference's ``server.microbatch.
    dispatchable_sizes``); empty when ``max_batch <= 0`` (no batcher)."""
    if max_batch <= 0:
        return []
    top = 1 << (max_batch - 1).bit_length() if max_batch > 1 else 1
    b, sizes = 1, []
    while b <= top:
        sizes.append(b)
        b <<= 1
    return sizes


def warm_batched_topk(table_t: torch.Tensor, rank: int, n: int,
                      unmasked_too: bool = False,
                      max_batch: int = 64) -> None:
    """Run the batched scorer once at every pow2 batch size the serving
    batcher can dispatch (default num rounded to 16) and at the small-k
    sizes at B=1, so the first real query pays no one-time device set-up
    (library handles, allocator growth)."""
    from ..ops.topk import batch_topk_scores_t, pow2_ceil

    ladder = pow2_ladder(max_batch)
    if not ladder:
        return
    dev = table_t.device

    def warm(b, k, masked):
        vecs = torch.zeros((b, rank), dtype=torch.float32, device=dev)
        mask = (torch.zeros((b, n), dtype=torch.float32, device=dev)
                if masked else None)
        batch_topk_scores_t(vecs, table_t, k, mask=mask)

    k_default = min(pow2_ceil(10), n)
    for b in ladder:
        warm(b, k_default, True)
        if unmasked_too:
            warm(b, k_default, False)
    for k in {min(pow2_ceil(k), n) for k in (1, 4)}:
        warm(1, k, True)
        if unmasked_too:
            warm(1, k, False)
