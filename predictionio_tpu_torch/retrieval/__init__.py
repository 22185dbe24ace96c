"""Two-stage retrieval on the serving path.

Port of ``predictionio_tpu/retrieval/__init__.py``.  ``ops/ann.py``
holds the math (quantization, coarse clustering, the candidate stages);
this package holds the lifecycle a serving process needs around it:

* :class:`RetrievalConfig` — the operator surface (engine.json keys
  ``retrieval`` / ``candidateFactor`` / ``nprobe`` / ``annClusters``),
  validated once at config time.
* :class:`TwoStageRetriever` — the quantized artifacts on the serving
  device (int8 table + per-row scale, or centroids + the cluster-sorted
  slabs for IVF), a ``search()`` that runs candidate -> exact rerank and
  books ``pio_retrieval_stage_seconds{stage=candidate|rerank}``, a
  ``warm()`` for the serving warm-up ladder, and an in-place
  :meth:`TwoStageRetriever.patch` for fold-in deltas that re-quantizes
  only the touched rows and appends new items to their nearest coarse
  cluster, with no index rebuild.

Tear-freedom follows the delta-apply idiom (``live/apply.py``): every
mutation lands as ONE attribute rebind of the state dict, built from new
tensors, so a concurrent ``search`` sees the old artifact set or the new
one, never a mixed (q_table, scale) pair mis-scaling a row.

The rerank table is not owned here: callers pass the model's current
device table per call, because fold-in rebinds those tables on every
delta apply.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, fence
from ..obs import RETRIEVAL_STAGE_SECONDS
from ..ops import ann
from ..ops.topk import pow2_ceil, rerank_topk

__all__ = ["RetrievalConfig", "TwoStageRetriever", "RETRIEVAL_MODES"]

RETRIEVAL_MODES = ("exact", "int8", "ivf")

# stage-histogram children cached at import: labels() is too hot for
# the per-query path
_m_candidate = RETRIEVAL_STAGE_SECONDS.labels(stage="candidate")
_m_rerank = RETRIEVAL_STAGE_SECONDS.labels(stage="rerank")


def _trace_fenced() -> bool:
    """``PIO_TPU_TRACE_RETRIEVAL=1`` fences each stage, so the stage
    histograms hold device time rather than enqueue time."""
    return os.environ.get("PIO_TPU_TRACE_RETRIEVAL", "") == "1"


@dataclass(frozen=True)
class RetrievalConfig:
    """How a serving path retrieves top-k.

    ``mode='exact'`` is the brute-force scan (the default).  ``'int8'``
    adds the flat quantized candidate stage; ``'ivf'`` additionally
    restricts the candidate scan to the ``nprobe`` nearest of
    ``clusters`` coarse clusters (``clusters=0`` auto-sizes to
    ~sqrt(M), pow2-rounded).  ``candidate_factor`` is the shortlist
    width in units of k."""

    mode: str = "exact"
    candidate_factor: int = 10
    nprobe: int = 8
    clusters: int = 0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.mode not in RETRIEVAL_MODES:
            raise ValueError(
                f"retrieval must be one of {RETRIEVAL_MODES}, "
                f"got {self.mode!r}"
            )
        if self.candidate_factor < 1:
            raise ValueError(
                f"candidate_factor must be >= 1, got {self.candidate_factor}"
            )
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.clusters < 0:
            raise ValueError(f"clusters must be >= 0, got {self.clusters}")

    @property
    def active(self) -> bool:
        return self.mode != "exact"

    def cache_key(self) -> str:
        """Keys the per-model retriever cache (``DeviceTableMixin``)."""
        return (
            f"{self.mode}_cf{self.candidate_factor}_np{self.nprobe}"
            f"_c{self.clusters}_s{self.seed}"
        )

    def resolve_clusters(self, n_items: int) -> int:
        if self.clusters > 0:
            return min(self.clusters, max(n_items, 1))
        # ~sqrt(M) balances the centroid scan (O(C)) against the member
        # scan (O(M/C))
        return max(min(pow2_ceil(int(np.sqrt(max(n_items, 1)))),
                       max(n_items, 1)), 1)


class TwoStageRetriever:
    """Quantized candidate artifacts + the two-stage search for ONE
    item table, on ``device``."""

    def __init__(self, cfg: RetrievalConfig, n_items: int, rank: int,
                 state: dict, device: torch.device):
        self.cfg = cfg
        self.n_items = n_items
        self.rank = rank
        self.device = device
        # ONE attribute carries every mutable artifact (device tensors
        # + host-side IVF bookkeeping): patch() builds a full
        # replacement dict and rebinds — the tear-freedom contract
        self._state = state
        self.patches = 0

    # -- build -------------------------------------------------------------
    @classmethod
    def build(cls, item_factors: np.ndarray, cfg: RetrievalConfig,
              device: DeviceLike = "cuda") -> "TwoStageRetriever":
        dev = torch.device(device)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        table = np.asarray(item_factors, np.float32)
        n_items, rank = table.shape
        q, scale = ann.quantize_rows(table)
        state: dict = {}
        if cfg.mode == "ivf":
            centroids, assign = ann.build_clusters(
                table, cfg.resolve_clusters(n_items), seed=cfg.seed
            )
            # a skewed catalog splits oversized clusters, so the layout
            # follows the centroids actually produced
            layout = ann.build_cluster_layout(
                q, scale, assign, len(centroids)
            )
            state.update(
                centroids=centroids,           # host: append assignment
                centroids_t=put(centroids.T),
                q_slabs=put(layout["q_slabs"]),
                slab_scale=put(layout["slab_scale"]),
                slab_ids=put(layout["slab_ids"]),
                # host-side patch addressing: item -> (cluster, slot)
                assign=np.asarray(assign, np.int64),
                slot=layout["slot"],
                fill=layout["fill"],
            )
        else:
            state["scale"] = put(scale)
            state["q_table_t"] = put(q.T)
        return cls(cfg, n_items, rank, state, dev)

    # -- search ------------------------------------------------------------
    def shortlist_width(self, k: int) -> int:
        """Candidate count per k, pow2-rounded like the batch ladders."""
        return min(pow2_ceil(self.cfg.candidate_factor * k), self.n_items)

    def search(self, query_vecs, k: int, table: torch.Tensor):
        """Two-stage top-k: quantized shortlist -> exact rerank against
        ``table`` (the caller's current unquantized device table).
        Returns ``([B, k] values, [B, k] int32 ids)`` with non-finite
        values for shortfall rows, as the exact scorers mask."""
        st = self._state
        q = torch.as_tensor(query_vecs, dtype=torch.float32,
                            device=self.device)
        q = q.reshape(-1, q.shape[-1])
        kc = self.shortlist_width(k)
        fenced = _trace_fenced()
        t0 = time.perf_counter()
        if self.cfg.mode == "ivf":
            cand = ann.ivf_candidate_topk(
                q, st["centroids_t"], st["q_slabs"], st["slab_scale"],
                st["slab_ids"],
                min(self.cfg.nprobe, st["q_slabs"].shape[0]), kc,
            )
        else:
            cand = ann.int8_candidate_topk(
                q, st["q_table_t"], st["scale"], kc
            )
        if fenced:
            fence(self.device)
        t1 = time.perf_counter()
        _m_candidate.observe(t1 - t0)
        vals, ixs = rerank_topk(q, table, cand, min(k, kc))
        if fenced:
            fence(self.device)
        _m_rerank.observe(time.perf_counter() - t1)
        return vals, ixs

    def warm(self, k: int, batches, table: torch.Tensor) -> None:
        """Run the candidate and rerank stages once at every batch size
        in ``batches`` at this k (the serving warm-up ladder)."""
        for b in batches:
            self.search(torch.zeros((b, self.rank), device=self.device),
                        k, table)

    # -- fold-in delta patch ------------------------------------------------
    def patch(self, ixs, rows, appended=None) -> dict:
        """Fold one model delta into the quantized index in place:
        re-quantize only the touched rows, append new items to their
        nearest coarse cluster, never a rebuild.  Returns the patch
        counts."""
        ixs = np.asarray(ixs, np.int64)
        rows = np.asarray(rows, np.float32) if len(ixs) else \
            np.zeros((0, self.rank), np.float32)
        app = (
            np.asarray(appended, np.float32)
            if appended is not None and len(appended) else None
        )
        if len(ixs) == 0 and app is None:
            return {"patched": 0, "appended": 0}
        st = dict(self._state)
        q_rows, s_rows = ann.quantize_rows(rows)
        q_app, s_app = (
            ann.quantize_rows(app) if app is not None else (None, None)
        )
        if self.cfg.mode == "ivf":
            self._patch_ivf(st, ixs, q_rows, s_rows, app, q_app, s_app)
        else:
            scale = st["scale"]
            qtt = st["q_table_t"]
            if q_app is not None:
                scale = torch.cat([scale, self._put(s_app)])
                qtt = torch.cat([qtt, self._put(q_app.T)], dim=1)
            else:
                scale, qtt = scale.clone(), qtt.clone()
            if len(ixs):
                ix = self._put(ixs)
                scale[ix] = self._put(s_rows)
                qtt[:, ix] = self._put(q_rows.T)
            st["scale"] = scale
            st["q_table_t"] = qtt
        n_app = 0 if app is None else len(app)
        self.n_items += n_app
        self._state = st
        self.patches += 1
        return {"patched": int(len(ixs)), "appended": n_app}

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _patch_ivf(self, st, ixs, q_rows, s_rows, app, q_app,
                   s_app) -> None:
        """Patched rows write their (cluster, slot) cells directly (the
        host-side ``slot`` map addresses the slab layout); appended rows
        take the next free slot of their nearest centroid, growing the
        padded capacity (one pad on the device, no re-quantization of
        anything existing) only when a cluster fills."""
        q_slabs = st["q_slabs"].clone()
        slab_scale = st["slab_scale"].clone()
        slab_ids = st["slab_ids"].clone()
        assign = st["assign"]
        slot = st["slot"]
        fill = st["fill"].copy()
        if len(ixs):
            c = self._put(assign[ixs])
            sl = self._put(slot[ixs].astype(np.int64))
            q_slabs[c, sl] = self._put(q_rows)
            slab_scale[c, sl] = self._put(s_rows)
        if app is not None:
            clusters = np.asarray(
                ann.nearest_cluster(app, st["centroids"]), np.int64
            )
            new_slots = np.empty(len(app), np.int32)
            for j, c in enumerate(clusters):
                new_slots[j] = fill[c]
                fill[c] += 1
            need = int(fill.max(initial=0))
            cap = q_slabs.shape[1]
            if need > cap:
                grow = int(need * 1.25) + 1 - cap
                n_c = q_slabs.shape[0]
                q_slabs = torch.cat([q_slabs, q_slabs.new_zeros(
                    (n_c, grow, q_slabs.shape[2]))], dim=1)
                slab_scale = torch.cat(
                    [slab_scale, slab_scale.new_zeros((n_c, grow))], dim=1)
                slab_ids = torch.cat(
                    [slab_ids, slab_ids.new_full((n_c, grow), -1)], dim=1)
            c = self._put(clusters)
            sl = self._put(new_slots.astype(np.int64))
            q_slabs[c, sl] = self._put(q_app)
            slab_scale[c, sl] = self._put(s_app)
            slab_ids[c, sl] = torch.arange(
                self.n_items, self.n_items + len(app), dtype=torch.int32,
                device=self.device)
            st["assign"] = np.concatenate([assign, clusters])
            st["slot"] = np.concatenate([slot, new_slots])
        st["q_slabs"] = q_slabs
        st["slab_scale"] = slab_scale
        st["slab_ids"] = slab_ids
        st["fill"] = fill

    # -- observability -----------------------------------------------------
    def summary(self) -> dict:
        """Status-JSON block (serving surfaces it as ``retrieval``)."""
        out = {
            "mode": self.cfg.mode,
            "items": self.n_items,
            "candidateFactor": self.cfg.candidate_factor,
            "patches": self.patches,
        }
        if self.cfg.mode == "ivf":
            st = self._state
            out.update(
                clusters=int(st["q_slabs"].shape[0]),
                clusterCapacity=int(st["q_slabs"].shape[1]),
                nprobe=self.cfg.nprobe,
            )
        return out
