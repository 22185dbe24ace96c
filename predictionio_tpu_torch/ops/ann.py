"""Quantized candidate stages for two-stage top-k retrieval.

Port of ``predictionio_tpu/ops/ann.py``.  The reference's candidate
stages are XLA programs, not Pallas kernels, so their port is torch
ops: an int8 symmetric per-row quantization of the item table scored
with f32 accumulation (:func:`int8_candidate_topk`), optionally only
over the ``nprobe`` nearest coarse clusters (:func:`ivf_candidate_topk`),
each keeping a shortlist of ``candidate_factor * k`` row ids for the
exact rerank (``ops/topk.rerank_topk``).  The rerank scores the kept
rows from the unquantized table, so approximation can only lose
candidates, never corrupt a kept candidate's score or rank.

The host code (quantization, the k-means cluster build, the
cluster-sorted slab layout, the nearest-cluster assignment of appended
rows and ``recall_at_k``) is the reference's NumPy, copied: the same
seed builds the same clusters bit for bit.

Ties: both candidate stages rank with ``ops/topk._top_k``, the order
``jax.lax.top_k`` gives (score descending, lower index first among
equal scores).  The scores themselves are f32 products whose summation
order is the device library's, so two scores that differ in their last
bits may compare the other way than in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import matmul_precision
from .topk import _top_k

__all__ = [
    "quantize_rows",
    "int8_candidate_topk",
    "ivf_candidate_topk",
    "build_clusters",
    "build_cluster_layout",
    "nearest_cluster",
    "recall_at_k",
]


# --------------------------------------------------------------------------
# int8 symmetric per-row quantization
# --------------------------------------------------------------------------


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: ``q = round(row / scale)``
    with ``scale = max|row| / 127`` kept alongside, so a dequantized
    dot is ``(q . x) * scale``.

    Per-ROW scales (not one tensor scale) because ALS factor rows span
    orders of magnitude of norm — a popular item's row would otherwise
    consume the whole int8 range and flatten the tail of the catalog
    to zero.  An all-zero row gets scale 1.0 (scores 0, like the f32
    scan would).  Returns ``(q [N, R] int8, scale [N] f32)``.
    """
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        raise ValueError(f"expected [N, R] rows, got shape {rows.shape}")
    amax = np.abs(rows).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(rows / scale[:, None]), -127, 127
    ).astype(np.int8)
    return q, scale


# --------------------------------------------------------------------------
# candidate stages (device)
# --------------------------------------------------------------------------


def int8_candidate_topk(query_vecs: torch.Tensor, q_table_t: torch.Tensor,
                        scale: torch.Tensor, kc: int) -> torch.Tensor:
    """Flat int8 candidate stage: ``[B, R] f32 x [R, M] int8`` (the
    pre-transposed serving layout) in f32, dequantized by the per-row
    scale, shortlisted to the top ``kc`` ids per query.  Returns
    ``[B, kc] int32``."""
    with matmul_precision("highest"):
        scores = (query_vecs @ q_table_t.to(torch.float32)) * scale[None, :]
    return _top_k(scores, kc)[1].to(torch.int32)


def ivf_candidate_topk(query_vecs: torch.Tensor, centroids_t: torch.Tensor,
                       q_slabs: torch.Tensor, slab_scale: torch.Tensor,
                       slab_ids: torch.Tensor, nprobe: int,
                       kc: int) -> torch.Tensor:
    """IVF candidate stage: route each query to its ``nprobe``
    best-scoring coarse clusters, then int8-score only those clusters'
    members, from the cluster-sorted ``q_slabs [C, L, R]`` (with
    ``slab_scale [C, L]`` and ``slab_ids [C, L]``, -1 = padding): a
    probe gathers ``nprobe`` contiguous ``L·R`` slabs.  Padding and any
    shortfall below ``kc`` candidates come back as ``-1`` ids, which
    the rerank masks to ``-inf``.  Returns ``[B, kc] int32`` global row
    ids."""
    b = query_vecs.shape[0]
    with matmul_precision("highest"):
        cscores = query_vecs @ centroids_t                  # [B, C]
        probe = _top_k(cscores, nprobe)[1]                  # [B, nprobe]
        blocks = q_slabs[probe].to(torch.float32)           # [B, np, L, R]
        s = torch.einsum("bplr,br->bpl", blocks, query_vecs)
    s = s * slab_scale[probe]
    ids = slab_ids[probe]                                   # [B, np, L]
    s = torch.where(ids >= 0, s, float("-inf")).reshape(b, -1)
    ids = ids.reshape(b, -1)
    vals, pos = _top_k(s, min(kc, s.shape[1]))
    ixs = torch.gather(ids, 1, pos)
    # shortfall (fewer live members than kc) must not leak padding ids
    return torch.where(torch.isfinite(vals), ixs, -1).to(torch.int32)


# --------------------------------------------------------------------------
# coarse clustering (host-side build; runs at model load, never per query)
# --------------------------------------------------------------------------


def _nearest_blocked(x: np.ndarray, centroids: np.ndarray,
                     block: int = 65536) -> np.ndarray:
    """argmin_c ||x - c||^2 == argmax_c (x.c - |c|^2/2), blocked over
    rows so a 10M-item assignment pass never materializes [M, C]."""
    half = 0.5 * np.einsum("cr,cr->c", centroids, centroids)
    out = np.empty(len(x), np.int32)
    for i in range(0, len(x), block):
        out[i:i + block] = np.argmax(
            x[i:i + block] @ centroids.T - half[None, :], axis=1
        )
    return out


def _split_oversized(table: np.ndarray, centroids: np.ndarray,
                     assign: np.ndarray, cap: int, rng,
                     max_rounds: int = 12) -> tuple[np.ndarray,
                                                    np.ndarray]:
    """Recursively 2-means-split every cluster above ``cap`` members.

    Capping cluster size is what bounds the IVF slab capacity ``L`` —
    and therefore the per-probe scan cost O(nprobe·L·R) — regardless
    of catalog density skew (unconstrained k-means on a genuinely
    clustered table produced a max cluster ~3.5x the mean, tripling
    every probe's work).  Splitting beats capacity-constrained greedy
    assignment because no item ever lands in a *wrong* cluster: a
    greedy cap bumps overflow items into arbitrary far clusters the
    probe stage then never finds (measured as a hard ~0.87 recall
    ceiling no nprobe could lift).  The cluster COUNT grows past the
    requested C instead — centroids stay faithful to their members.
    """
    cents = list(centroids)
    for _ in range(max_rounds):
        counts = np.bincount(assign, minlength=len(cents))
        big = np.where(counts > cap)[0]
        if len(big) == 0:
            break
        for c in big:
            ixs = np.where(assign == c)[0]
            pts = table[ixs]
            # 2-means seeded far apart (a point + its farthest member)
            a = pts[rng.integers(len(pts))]
            two = np.stack([a, pts[np.argmax(((pts - a) ** 2).sum(1))]])
            lab = np.zeros(len(pts), np.int64)
            for _ in range(4):
                d = pts @ two.T - 0.5 * np.einsum("cr,cr->c", two, two)
                lab = np.argmax(d, axis=1)
                for j in (0, 1):
                    if (lab == j).any():
                        two[j] = pts[lab == j].mean(axis=0)
            cents[c] = two[0]
            cents.append(two[1])
            assign[ixs[lab == 1]] = len(cents) - 1
    return np.asarray(cents, np.float32), assign


def build_clusters(table: np.ndarray, n_clusters: int, *, seed: int = 0,
                   iters: int = 6, sample: int = 131072,
                   block: int = 65536,
                   balance: float = 1.5) -> tuple[np.ndarray, np.ndarray]:
    """k-means over the item factors: Lloyd iterations on a bounded
    sample (catalog-size-independent build cost), ONE blocked
    full-catalog assignment pass, then oversized clusters are
    recursively split (:func:`_split_oversized`) until every cluster
    holds at most ``balance * m / n_clusters`` items — the returned
    cluster count can therefore exceed ``n_clusters`` on skewed data.
    Empty clusters keep their previous centroid (they stay addressable
    for pio-live appends).  Returns ``(centroids [C', R] f32,
    assign [M])``.
    """
    table = np.asarray(table, np.float32)
    m = len(table)
    n_clusters = max(min(n_clusters, m), 1)
    rng = np.random.default_rng(seed)
    train = (
        table[rng.choice(m, sample, replace=False)]
        if m > sample else table
    )
    centroids = train[
        rng.choice(len(train), n_clusters, replace=False)
    ].copy()
    for _ in range(max(iters, 1)):
        assign = _nearest_blocked(train, centroids, block)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assign, train)
        counts = np.bincount(assign, minlength=n_clusters)
        live = counts > 0
        centroids[live] = sums[live] / counts[live, None]
    assign = _nearest_blocked(table, centroids, block).astype(np.int64)
    cap = max(int(np.ceil(balance * m / n_clusters)), 1)
    return _split_oversized(table, centroids, assign, cap, rng)


def build_cluster_layout(
    q: np.ndarray, scale: np.ndarray, assign: np.ndarray,
    n_clusters: int, *, slack: float = 1.25, min_capacity: int = 8,
) -> dict:
    """Sort the quantized table into the cluster-contiguous slab
    layout :func:`ivf_candidate_topk` scans:

    * ``q_slabs [C, L, R]`` int8 — cluster ``c``'s quantized rows,
      zero-padded to capacity ``L``
    * ``slab_scale [C, L]`` f32 / ``slab_ids [C, L]`` int32 (-1 pad)
    * ``slot [M]`` int32 — each item's within-cluster position, so a
      pio-live delta patch addresses its (cluster, slot) cell directly
    * ``fill [C]`` int64 — live members per cluster (append cursor)

    Capacity ``L`` is the largest cluster plus ``slack`` headroom so
    fold-in appends rarely force a capacity grow (a grow is a
    host-side pad + one slab re-upload — the quantization itself is
    untouched, which is the no-rebuild contract)."""
    assign = np.asarray(assign, np.int64)
    m, rank = q.shape
    counts = np.bincount(assign, minlength=n_clusters)
    cap = max(int(np.ceil((counts.max() if m else 0) * slack)),
              min_capacity)
    q_slabs = np.zeros((n_clusters, cap, rank), np.int8)
    slab_scale = np.zeros((n_clusters, cap), np.float32)
    slab_ids = np.full((n_clusters, cap), -1, np.int32)
    slot = np.empty(m, np.int32)
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    starts = np.searchsorted(sa, np.arange(n_clusters))
    within = np.arange(m) - starts[sa]
    slot[order] = within
    q_slabs[sa, within] = q[order]
    slab_scale[sa, within] = scale[order]
    slab_ids[sa, within] = order
    return {
        "q_slabs": q_slabs,
        "slab_scale": slab_scale,
        "slab_ids": slab_ids,
        "slot": slot,
        "fill": counts.astype(np.int64),
    }


def nearest_cluster(rows: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Cluster assignment for a few appended rows (pio-live fold-in:
    new items join their nearest coarse cluster in place)."""
    return _nearest_blocked(np.atleast_2d(
        np.asarray(rows, np.float32)
    ), centroids)


# --------------------------------------------------------------------------
# the honesty metric
# --------------------------------------------------------------------------


def recall_at_k(exact_ix: np.ndarray, approx_ix: np.ndarray) -> float:
    """Mean per-query fraction of the exact-scan top-k ids the
    approximate result also returned (order-insensitive — the rerank
    stage's exact scores settle order among kept candidates).  The
    number `tools/bench_ann.py` records as ``ann_recall_at_10`` and
    the gate judges direction-up."""
    exact_ix = np.atleast_2d(np.asarray(exact_ix))
    approx_ix = np.atleast_2d(np.asarray(approx_ix))
    if exact_ix.shape[0] != approx_ix.shape[0]:
        raise ValueError(
            f"query counts differ: {exact_ix.shape} vs {approx_ix.shape}"
        )
    hits = 0
    for e, a in zip(exact_ix, approx_ix):
        hits += len(set(e.tolist()) & set(a.tolist()))
    return hits / max(exact_ix.size, 1)
