"""Item-to-item similarity at catalog scale: cosine on the two-stage
retriever.

Port of ``predictionio_tpu/templates/itemsimilarity.py``.  The model
stores the item table row-normalized, so inner product over it is cosine,
and the int8/IVF candidate stage with its exact f32 rerank
(:class:`~predictionio_tpu_torch.retrieval.TwoStageRetriever`) retrieves
by cosine with no kernel of its own.  The query items are dropped on the
host from an over-fetched shortlist (``pow2_ceil(num + |query items|)``
keeps the shapes few); a filtered query (categories, white or black
list) takes the exact masked scorer, as in the recommendation template.

Wire format as similarproduct's: query ``{"items": [...], "num": 4,
...filters}``; result ``{"itemScores": [...]}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..controller import (
    Algorithm,
    Engine,
    FirstServing,
    IdentityPreparator,
    ModelPlacement,
    Params,
    WorkflowContext,
)
from ..models.als import train_als
from ..ops.topk import batch_topk_scores_t, pow2_ceil, topk_scores
from ._common import (
    DeviceTableMixin,
    filter_bias_mask,
    normalize_rows,
    pow2_ladder,
    warm_batched_topk,
)
from .recommendation import (
    ItemScore,
    PredictedResult,
    decode_batch_item_scores,
    decode_item_scores,
)
from .similarproduct import Query, SimilarProductDataSource, _implicit_config

__all__ = [
    "ItemSimilarityAlgorithm",
    "ItemSimilarityModel",
    "ItemSimilarityParams",
    "itemsimilarity_engine",
    "itemsimilarity_evaluation",
]


@dataclass(frozen=True)
class ItemSimilarityParams(Params):
    __param_aliases__ = {"lambda": "lam"}

    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    solver: str = "xla"
    factor_placement: str = "replicated"
    # two-stage cosine: "ivf" is the catalog-scale default; "exact"
    # restores the full scan
    retrieval: str = "ivf"
    candidate_factor: int = 10
    nprobe: int = 8
    ann_clusters: int = 0

    def __post_init__(self) -> None:
        if self.retrieval not in ("exact", "int8", "ivf"):
            raise ValueError(
                f"retrieval must be 'exact', 'int8' or 'ivf', "
                f"got {self.retrieval!r}"
            )
        if self.candidate_factor < 1:
            raise ValueError(
                f"candidateFactor must be >= 1, got {self.candidate_factor}"
            )
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.ann_clusters < 0:
            raise ValueError(
                f"annClusters must be >= 0, got {self.ann_clusters}"
            )


@dataclass
class ItemSimilarityModel(DeviceTableMixin):
    """``item_factors`` is row-normalized at train time: every scorer
    (exact, int8, IVF) computes cosine as a plain inner product, and the
    quantized index holds unit-norm rows."""

    item_factors: np.ndarray
    items: Any  # StringIndex
    item_props: dict[str, dict]
    device: torch.device = torch.device("cuda")

    def sanity_check(self) -> None:
        if not np.isfinite(self.item_factors).all():
            raise ValueError("item factors contain non-finite values")


class ItemSimilarityAlgorithm(Algorithm):
    """Implicit ALS -> normalized item table -> two-stage cosine."""

    params_class = ItemSimilarityParams
    placement = ModelPlacement.DEVICE_SHARDED

    def train(self, ctx: WorkflowContext, data) -> ItemSimilarityModel:
        factors = train_als(data.ratings, cfg=_implicit_config(self.params),
                            device=ctx.device)
        return ItemSimilarityModel(
            item_factors=normalize_rows(factors.item_factors),
            items=data.ratings.items,
            item_props=data.items,
            device=ctx.device,
        )

    def _retrieval_config(self):
        p = self.params
        if p.retrieval == "exact":
            return None
        from ..retrieval import RetrievalConfig

        return RetrievalConfig(
            mode=p.retrieval,
            candidate_factor=p.candidate_factor,
            nprobe=p.nprobe,
            clusters=p.ann_clusters,
        )

    # -- serving -----------------------------------------------------------
    def warmup(self, model: ItemSimilarityModel,
               max_batch: int = 64) -> None:
        """Run the exact masked scorer at the common shapes and, with a
        two-stage retriever, its search at every pow2 batch the batcher
        can dispatch at the over-fetch widths one- and few-item queries
        take (k + |query items| rounds up)."""
        n = len(model.items)
        if n == 0:
            return
        table = model.device_item_factors()  # already normalized
        rank = model.item_factors.shape[1]
        vec = torch.zeros(rank, dtype=torch.float32, device=model.device)
        bias = torch.zeros(n, dtype=torch.float32, device=model.device)
        for k in {min(k, n) for k in (1, 4, 10, 20)}:
            topk_scores(vec, table, k, bias=bias)
        warm_batched_topk(model.device_item_factors_t(), rank, n,
                          max_batch=max_batch)
        rcfg = self._retrieval_config()
        if rcfg is not None:
            idx = model.device_ann_index(rcfg)
            ladder = pow2_ladder(max_batch) + [1]
            for k in {min(pow2_ceil(kk), n) for kk in (11, 16)}:
                idx.warm(k, ladder, table)

    def _known_and_qvec(self, model: ItemSimilarityModel, query: Query):
        known = [model.items.get(i) for i in query.items]
        known = [i for i in known if i >= 0]
        if not known or query.num <= 0:
            return None, None
        qvec = model.item_factors[known].mean(axis=0)
        qn = qvec / (np.linalg.norm(qvec) + 1e-9)
        return known, np.asarray(qn, np.float32)

    def _has_filters(self, query: Query) -> bool:
        return bool(query.categories or query.whitelist or query.blacklist)

    def _exact_mask(self, model, query, known):
        return filter_bias_mask(
            model.items, model.item_props,
            categories=query.categories, whitelist=query.whitelist,
            blacklist=query.blacklist or (), exclude_ix=known,
        )

    @staticmethod
    def _decode_excluding(model, vals, ixs, num, exclude) -> tuple:
        """Host decode of one over-fetched shortlist row: drop the query
        items and the non-finite entries, keep ``num``."""
        ex = set(int(i) for i in exclude)
        out = []
        for v, ix in zip(vals.tolist(), ixs.tolist()):
            if not np.isfinite(v) or ix in ex:
                continue
            out.append(ItemScore(item=str(model.items.id_of(ix)), score=v))
            if len(out) >= num:
                break
        return tuple(out)

    def predict(self, model: ItemSimilarityModel,
                query: Query) -> PredictedResult:
        known, qn = self._known_and_qvec(model, query)
        if known is None:
            return PredictedResult(item_scores=())
        n = len(model.items)
        k = min(query.num, n)
        qt = torch.as_tensor(qn, device=model.device)
        rcfg = self._retrieval_config()
        if rcfg is not None and not self._has_filters(query):
            # over-fetch to survive dropping the query items themselves
            kq = min(pow2_ceil(k + len(known)), n)
            vals, ixs = model.device_ann_index(rcfg).search(
                qt[None, :], kq, model.device_item_factors()
            )
            return PredictedResult(item_scores=self._decode_excluding(
                model, vals[0].cpu().numpy(), ixs[0].cpu().numpy(),
                query.num, known,
            ))
        mask = self._exact_mask(model, query, known)
        vals, ixs = topk_scores(qt, model.device_item_factors(), k,
                                bias=torch.as_tensor(mask,
                                                     device=model.device))
        return PredictedResult(
            item_scores=decode_item_scores(model.items, vals, ixs)
        )

    def batch_predict(self, model: ItemSimilarityModel, queries):
        """Micro-batched serving and eval: one batched two-stage search
        (or one batched masked exact product) for the whole batch, the
        device batch ``len(queries)`` and k a power of two."""
        out = [PredictedResult(item_scores=()) for _ in queries]
        n = len(model.items)
        if n == 0 or not queries:
            return out
        rank = model.item_factors.shape[1]
        qvecs = np.zeros((len(queries), rank), np.float32)
        knowns: list[list[int]] = [[] for _ in queries]
        valid = np.zeros(len(queries), bool)
        any_filters = False
        for bi, q in enumerate(queries):
            known, qn = self._known_and_qvec(model, q)
            if known is None:
                continue
            valid[bi] = True
            qvecs[bi] = qn
            knowns[bi] = known
            any_filters = any_filters or self._has_filters(q)
        if not valid.any():
            return out
        max_num = max(q.num for q, v in zip(queries, valid) if v)
        qt = torch.as_tensor(qvecs, device=model.device)
        rcfg = self._retrieval_config()
        if rcfg is not None and not any_filters:
            max_known = max(len(kn) for kn in knowns)
            kq = min(pow2_ceil(max_num + max_known), n)
            vals, ixs = model.device_ann_index(rcfg).search(
                qt, kq, model.device_item_factors()
            )
            vals, ixs = vals.cpu().numpy(), ixs.cpu().numpy()
            for bi, q in enumerate(queries):
                if valid[bi]:
                    out[bi] = PredictedResult(
                        item_scores=self._decode_excluding(
                            model, vals[bi], ixs[bi], q.num, knowns[bi]
                        ))
            return out
        k = min(pow2_ceil(max_num), n)
        masks = np.zeros((len(queries), n), np.float32)
        for bi, q in enumerate(queries):
            if valid[bi]:
                masks[bi] = self._exact_mask(model, q, knowns[bi])
        vals, ixs = batch_topk_scores_t(
            qt, model.device_item_factors_t(), k,
            mask=torch.as_tensor(masks, device=model.device),
        )
        decoded = decode_batch_item_scores(
            model.items, vals, ixs, [q.num for q in queries], valid, k
        )
        return [PredictedResult(item_scores=s) for s in decoded]


def itemsimilarity_engine() -> Engine:
    return Engine(
        SimilarProductDataSource,
        IdentityPreparator,
        {"cosine": ItemSimilarityAlgorithm, "": ItemSimilarityAlgorithm},
        FirstServing,
    )


def itemsimilarity_evaluation(app_name: str = "MyApp", k: int = 10,
                              holdout: float = 0.3):
    """MAP@k evaluation binding: ``eval --engine itemsimilarity`` scores
    the exact scan against the two-stage IVF retriever on a
    leave-some-out co-view split."""
    from ..controller import Evaluation
    from ..controller.metrics import MAPatK

    engine = itemsimilarity_engine()
    eps = []
    for retrieval in ("exact", "ivf"):
        eps.append(engine.params_from_variant({
            "datasource": {"params": {
                "appName": app_name,
                "evalHoldout": holdout, "evalNum": k,
            }},
            "algorithms": [{"name": "cosine", "params": {
                "rank": 8, "numIterations": 5, "lambda": 0.05,
                "alpha": 2.0, "seed": 3, "retrieval": retrieval,
                "candidateFactor": 10, "nprobe": 8,
            }}],
        }))
    return Evaluation(engine, MAPatK(k), engine_params_list=eps)


# -- registration --------------------------------------------------------


def _conformance_events():
    from .similarproduct import _conformance_events as sim_events

    return sim_events()


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

itemsimilarity_engine = engine_spec(
    "itemsimilarity",
    description=(
        "Item-to-item cosine similarity at catalog scale: normalized "
        "item table on the two-stage int8/IVF retriever"
    ),
    default_params={
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {
                "name": "cosine",
                "params": {"rank": 10, "numIterations": 20,
                           "lambda": 0.01, "seed": 3,
                           "retrieval": "ivf", "candidateFactor": 10,
                           "nprobe": 8},
            }
        ],
    },
    query_example={"items": ["1"], "num": 4},
    evaluation=itemsimilarity_evaluation,
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"items": ["i0"], "num": 3},),
        check=lambda r: len(r.get("itemScores", [])) >= 1
        and all(s["item"] != "i0" for s in r["itemScores"]),
        variant={
            "datasource": {"params": {"appName": "forge-conf"}},
            "algorithms": [
                {"name": "cosine",
                 "params": {"rank": 4, "numIterations": 3,
                            "lambda": 0.1, "alpha": 10.0, "seed": 1,
                            "retrieval": "int8",
                            "candidateFactor": 16}}
            ],
        },
    ),
)(itemsimilarity_engine)
