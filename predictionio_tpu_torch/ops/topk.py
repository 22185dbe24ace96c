"""Batched scoring + top-k (the serving hot path).

Port of ``predictionio_tpu/ops/topk.py``, which is plain XLA in the
reference (no Pallas kernel): one matrix product and a top-k per (batch
of) queries.  Here it is ``torch.matmul`` and ``torch.topk``, in true f32
(TF32 off inside these calls).

Tie-break: among equal scores the lower item index comes first, the
order ``jax.lax.top_k`` gives, on every device (``torch.topk`` alone
leaves the order of ties to the device; :func:`_top_k` ranks a key
with no ties instead).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import matmul_precision

__all__ = ["topk_scores", "batch_topk_scores", "batch_topk_scores_t",
           "cosine_topk", "pow2_ceil", "rerank_topk"]


def pow2_ceil(x: int) -> int:
    """Next power of two >= x (min 1).  Serving rounds batch sizes and k
    up to powers of two so the shapes a card sees stay few."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def _top_k(scores: torch.Tensor, k: int):
    """Top ``k`` along the last axis, in ``lax.top_k`` order: score
    descending, lower index first among equal scores.

    One ``torch.topk`` over an int64 key that no two entries share: the
    f32 score's bits mapped to an int32 of the same order (negative
    scores have their 31 low bits flipped; ``+ 0.0`` makes -0.0 equal to
    0.0 first) in the high half, and ``M - 1 - index`` in the low half."""
    m = scores.shape[-1]
    bits = (scores.float() + 0.0).contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    low = torch.arange(m - 1, -1, -1, dtype=torch.int64, device=scores.device)
    key = torch.add(low, bits.to(torch.int64), alpha=1 << 32)
    ixs = torch.topk(key, k, dim=-1).indices
    return torch.gather(scores, -1, ixs), ixs


def topk_scores(query_vec: torch.Tensor, table: torch.Tensor, k: int,
                bias: Optional[torch.Tensor] = None):
    """scores = table @ query_vec (+bias); returns (values, indices) top-k."""
    with matmul_precision("highest"):
        scores = table @ query_vec.to(table.dtype)
    scores = scores.to(torch.float32)
    if bias is not None:
        scores = scores + bias
    return _top_k(scores, k)


def batch_topk_scores(query_vecs: torch.Tensor, table: torch.Tensor, k: int,
                      mask: Optional[torch.Tensor] = None):
    """[B, R] x [M, R] -> top-k per row; ``mask`` (additive, [B, M] or
    [M]) suppresses entries (use -inf)."""
    with matmul_precision("highest"):
        scores = query_vecs.to(table.dtype) @ table.T
    scores = scores.to(torch.float32)
    if mask is not None:
        scores = scores + mask
    return _top_k(scores, k)


def batch_topk_scores_t(query_vecs: torch.Tensor, table_t: torch.Tensor,
                        k: int, mask: Optional[torch.Tensor] = None):
    """[B, R] x [R, M] (pre-transposed table) -> top-k per row; the same
    math as :func:`batch_topk_scores` on the serving layout the model
    caches (``DeviceTableMixin.device_item_factors_t``)."""
    with matmul_precision("highest"):
        scores = query_vecs.to(table_t.dtype) @ table_t
    scores = scores.to(torch.float32)
    if mask is not None:
        scores = scores + mask
    return _top_k(scores, k)


def rerank_topk(query_vecs: torch.Tensor, table: torch.Tensor,
                cand_ix: torch.Tensor, k: int):
    """Exact rerank stage of two-stage retrieval: gather the ``[B, P]``
    candidate rows from the unquantized serving table and top-k them
    with the full-precision dot products the exact scan computes, so
    the candidate stage can only lose recall, never corrupt a kept
    candidate's score or rank.  ``cand_ix`` entries of ``-1`` (IVF
    padding, a candidate shortfall) score ``-inf``, which the template
    decode drops; so does an id past ``table``'s rows (an item that a
    fold-in appended to the index after the caller took its table),
    which is never gathered.  Returns ``([B, k] values, [B, k] int32
    ids)``."""
    held = (cand_ix >= 0) & (cand_ix < table.shape[0])
    rows = table[torch.where(held, cand_ix, 0).long()].to(torch.float32)
    with matmul_precision("highest"):
        scores = torch.einsum("bpr,br->bp", rows,               # [B, P]
                              query_vecs.to(torch.float32))
    scores = torch.where(held, scores, float("-inf"))
    vals, pos = _top_k(scores, k)
    return vals, torch.gather(cand_ix, 1, pos)


def cosine_topk(query_vec: torch.Tensor, table: torch.Tensor, k: int):
    """Cosine similarity top-k (the similar-product scoring)."""
    qn = query_vec / (torch.linalg.vector_norm(query_vec) + 1e-9)
    tn = table / (torch.linalg.vector_norm(table, dim=-1, keepdim=True)
                  + 1e-9)
    with matmul_precision("highest"):
        scores = tn @ qn
    return _top_k(scores, k)
