"""Recommendation engine template — the port's end-to-end slice.

Port of ``predictionio_tpu/templates/recommendation.py`` (PredictionIO's
scala-parallel-recommendation template): ratings → ALS training
(:func:`predictionio_tpu_torch.models.als.train_als`, through the CUDA
kernels for ``solver="pallas"``/``"fused"``) → top-K serving as one
matrix product and a top-k per (batch of) queries
(:mod:`predictionio_tpu_torch.ops.topk`).

Wire format parity: query ``{"user": "u1", "num": 4, "categories": [...],
"whitelist": [...], "blacklist": [...]}``; result
``{"itemScores": [{"item": ..., "score": ...}]}``.

The data source reads rate events and item properties from the event
store of the ``WorkflowContext``'s storage, as the reference's does
(single process; the multi-host COO exchange is not ported yet), and
splits them into k folds for evaluation (``read_eval``): an ALS whose
predictions are point ratings (:class:`RatingAlgorithm`) is scored by
:class:`RMSEMetric` over each fold's held-out ratings
(:func:`recommendation_evaluation`, the sweep behind ``eval --engine
recommendation``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    ModelPlacement,
    Params,
    WorkflowContext,
)
from ..models.als import ALSConfig, train_als
from ..ops.topk import batch_topk_scores_t, pow2_ceil, topk_scores
from ..storage.columnar import Ratings
from ..storage.levents import EventStore
from ._common import (
    DeviceTableMixin,
    filter_bias_mask,
    pow2_ladder,
    warm_batched_topk,
)

logger = logging.getLogger(__name__)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "ALSModel",
    "ActualRating",
    "ItemScore",
    "PredictedResult",
    "Query",
    "DataSourceParams",
    "RMSEMetric",
    "RatingAlgorithm",
    "RatingPrediction",
    "RecommendationDataSource",
    "RecommendationServing",
    "TrainingData",
    "recommendation_engine",
    "recommendation_evaluation",
]


# --------------------------------------------------------------------------
# Queries / results (wire format parity)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    categories: Optional[tuple[str, ...]] = None
    whitelist: Optional[tuple[str, ...]] = None
    blacklist: Optional[tuple[str, ...]] = None

    @staticmethod
    def from_json(d: dict) -> "Query":
        # reference wire format uses camelCase whiteList/blackList
        wl = d.get("whiteList") or d.get("whitelist")
        bl = d.get("blackList") or d.get("blacklist")
        return Query(
            user=str(d["user"]),
            num=int(d.get("num", 10)),
            categories=tuple(d["categories"]) if d.get("categories") else None,
            whitelist=tuple(wl) if wl else None,
            blacklist=tuple(bl) if bl else None,
        )


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...]

    def to_json(self) -> dict:
        return {
            "itemScores": [
                {"item": s.item, "score": s.score} for s in self.item_scores
            ]
        }


# --------------------------------------------------------------------------
# DataSource
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = -1
    event_names: tuple[str, ...] = ("rate",)
    rating_property: Optional[str] = "rating"
    entity_type: str = "user"
    target_entity_type: str = "item"
    item_entity_type: str = "item"
    eval_k: int = 0          # >0 enables k-fold read_eval
    eval_seed: int = 3
    # multi-process COO handling: "gathered" (every process receives the
    # full rating set) or "local" (each process keeps only its scan
    # shard, globally id-encoded, and the algorithm exchanges triples
    # to each row's owning shard through ALSTrainer.distributed: no
    # process holds the full COO; needs factorPlacement="sharded")
    coo: str = "gathered"

    def __post_init__(self) -> None:
        if self.coo not in ("gathered", "local"):
            raise ValueError(
                f"coo must be 'gathered' or 'local', got {self.coo!r}"
            )


@dataclass
class TrainingData:
    ratings: Ratings
    items: dict[str, dict] = field(default_factory=dict)  # item -> properties
    # True when `ratings` is this process's shard of a multi-process
    # read (globally id-encoded): the algorithm trains it through
    # ALSTrainer.distributed
    coo_local: bool = False

    def sanity_check(self) -> None:
        n = len(self.ratings)
        if self.coo_local:
            # a local shard may be empty on skewed data; only the global
            # count matters (every process runs this check)
            from ..parallel.ingest import global_count

            n = global_count(n)
        if n == 0:
            raise ValueError("no rating events found — is the app empty?")


def decode_item_scores(items, vals: torch.Tensor, ixs: torch.Tensor) -> tuple:
    """One device-to-host copy of both top-k outputs, then decode to
    :class:`ItemScore` rows, dropping -inf-masked entries."""
    vals, ixs = vals.cpu().numpy(), ixs.cpu().numpy()
    ok = np.isfinite(vals)
    ids = items.decode(ixs[ok])
    return tuple(
        ItemScore(item=str(i), score=float(s))
        for i, s in zip(ids, vals[ok])
    )


def decode_batch_item_scores(items, vals, ixs, nums, valid, k):
    """Host-side decode of a batched top-k: one copy for the whole
    batch, then per-query slicing to ``min(num, k)`` with -inf-masked
    entries dropped."""
    vals, ixs = vals.cpu().numpy(), ixs.cpu().numpy()
    out = [()] * len(nums)
    for bi, (num, ok_q) in enumerate(zip(nums, valid)):
        if not ok_q:
            continue
        m = min(num, k)
        ok = np.isfinite(vals[bi, :m])
        ids = items.decode(ixs[bi, :m][ok])
        out[bi] = tuple(
            ItemScore(item=str(it), score=float(s))
            for it, s in zip(ids, vals[bi, :m][ok])
        )
    return out


def _resolve_app_id(ctx: WorkflowContext, p: DataSourceParams) -> int:
    if p.app_id >= 0:
        return p.app_id
    app = ctx.storage.get_metadata().app_get_by_name(p.app_name)
    if app is None:
        raise ValueError(f"app {p.app_name!r} not found")
    return app.id


class RecommendationDataSource(DataSource):
    """Reads rate events + item properties
    (reference template `DataSource.scala:29-66`)."""

    params_class = DataSourceParams

    def _read_items(self, es: EventStore, app_id: int) -> dict[str, dict]:
        p: DataSourceParams = self.params
        return {
            k: dict(v.fields)
            for k, v in es.aggregate_properties_of(
                app_id=app_id, entity_type=p.item_entity_type
            ).items()
        }

    def _read(self, ctx: WorkflowContext) -> tuple[Ratings, dict]:
        """The ratings and the items' properties, the one read of
        ``read_training`` and ``read_eval``."""
        p: DataSourceParams = self.params
        app_id = _resolve_app_id(ctx, p)
        es: EventStore = ctx.storage.get_event_store()
        dedup = "last" if p.rating_property else "sum"
        if hasattr(es, "find_ratings"):
            # the SQLite store's training read (the native fused scan
            # and encode); rating_property=None is the implicit-count
            # mode
            ratings = es.find_ratings(
                app_id=app_id,
                event_names=p.event_names,
                rating_property=p.rating_property,
                dedup=dedup,
                entity_type=p.entity_type,
            )
        else:
            ratings = es.find_columnar(
                app_id=app_id,
                entity_type=p.entity_type,
                event_names=list(p.event_names),
                float_property=p.rating_property,
                minimal=True,   # only to_ratings fields are consumed
            ).to_ratings(rating_property=p.rating_property, dedup=dedup)
        return ratings, self._read_items(es, app_id)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        from ..parallel.mesh import process_count

        if process_count() > 1:
            return self._read_distributed(ctx)
        ratings, items = self._read(ctx)
        return TrainingData(ratings=ratings, items=items)

    def _read_distributed(self, ctx: WorkflowContext) -> TrainingData:
        """A multi-process run's read: each process scans its
        entity-hash shard, the id dictionaries are exchanged, and the
        ratings are all-gathered (``coo='gathered'``) or kept local."""
        from ..parallel.ingest import read_ratings_distributed

        p: DataSourceParams = self.params
        app_id = _resolve_app_id(ctx, p)
        es: EventStore = ctx.storage.get_event_store()
        ratings = read_ratings_distributed(
            es,
            exchange_dir=ctx.storage.model_data_dir() / "_ingest",
            tag=f"app{app_id}",
            rating_property=p.rating_property,
            dedup="last" if p.rating_property else "sum",
            gather=(p.coo == "gathered"),
            app_id=app_id,
            entity_type=p.entity_type,
            event_names=list(p.event_names),
        )
        return TrainingData(ratings=ratings,
                            items=self._read_items(es, app_id),
                            coo_local=(p.coo == "local"))

    def read_eval(self, ctx: WorkflowContext):
        """k-fold split (e2 `CrossValidation.scala:33-63` semantics: fold i
        holds out every k-th rating after a seeded shuffle, so folds are
        deterministic and size-balanced).  The ratings are the training
        read's: ``find_ratings`` gives the reference's
        ``find_columnar -> to_ratings`` ratings bit for bit, in the same
        order.  The held-out pairs keep the ratings' order; queries are
        frozen, so one per user serves all of that user's held-out
        ratings."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        ratings, items = self._read(ctx)
        n = len(ratings)
        perm = np.random.default_rng(p.eval_seed).permutation(n)
        fold = np.empty(n, dtype=np.int64)
        fold[perm] = np.arange(n) % p.eval_k
        queries = [Query(user=u, num=0) for u in ratings.users.ids.tolist()]
        out = []
        for f in range(p.eval_k):
            tr = fold != f
            te = ~tr
            train = Ratings(
                user_ix=ratings.user_ix[tr],
                item_ix=ratings.item_ix[tr],
                rating=ratings.rating[tr],
                users=ratings.users,
                items=ratings.items,
            )
            qa = list(zip(
                [queries[u] for u in ratings.user_ix[te].tolist()],
                map(ActualRating,
                    ratings.items.decode(ratings.item_ix[te]).tolist(),
                    ratings.rating[te].tolist()),
            ))
            out.append(
                (TrainingData(ratings=train, items=items), {"fold": f}, qa))
        return out


@dataclass(frozen=True, slots=True)
class ActualRating:
    item: str
    rating: float


# --------------------------------------------------------------------------
# ALS algorithm
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """engine.json parity: {"rank": 10, "numIterations": 20, "lambda": 0.01,
    "seed": 3} (reference `custom-query/engine.json:11-20`); the same
    fields as the JAX template's params."""

    __param_aliases__ = {"lambda": "lam"}

    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    seed: int = 3
    implicit: bool = False
    alpha: float = 1.0
    weighted_lambda: bool = True
    # serve-time scoring dtype: "float32" or "bfloat16"
    serving_dtype: str = "float32"
    gather_dtype: str = "float32"
    gather_mode: str = "row"
    # batched SPD solver: "xla" | "pallas" | "fused"
    solver: str = "xla"
    fused_gather: str = "auto"
    solver_mode: str = "full"
    subspace_size: int = 16
    factor_placement: str = "replicated"
    coded_shards: bool = False
    distributed_topk: bool = False
    retrieval: str = "exact"
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
                f"candidateFactor must be >= 1, "
                f"got {self.candidate_factor}"
            )
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.ann_clusters < 0:
            raise ValueError(
                f"annClusters must be >= 0, got {self.ann_clusters}"
            )
        if self.serving_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"servingDtype must be 'float32' or 'bfloat16', "
                f"got {self.serving_dtype!r}"
            )
        if self.distributed_topk:
            raise NotImplementedError(
                "distributedTopk is not yet ported to predictionio_tpu_torch "
                "(ROADMAP Queue 1 item 7)"
            )


@dataclass
class ALSModel(DeviceTableMixin):
    """Factor tables + id dictionaries + item metadata for filtering,
    served from ``device``."""

    user_factors: np.ndarray
    item_factors: np.ndarray
    users: Any   # StringIndex
    items: Any   # StringIndex
    item_props: dict[str, dict]
    device: torch.device = torch.device("cuda")

    def sanity_check(self) -> None:
        if not np.isfinite(self.user_factors).all():
            raise ValueError("user factors contain non-finite values")
        if not np.isfinite(self.item_factors).all():
            raise ValueError("item factors contain non-finite values")


class ALSAlgorithm(Algorithm):
    """MLlib-ALS-equivalent on one CUDA device
    (reference template `ALSAlgorithm.scala` train ~:24-77, predict :79-105).

    After :meth:`train`, ``train_report`` holds what the training run
    measured (per-half fenced seconds, sweep losses, staging)."""

    params_class = ALSAlgorithmParams
    placement = ModelPlacement.DEVICE_SHARDED

    def _config(self) -> ALSConfig:
        p: ALSAlgorithmParams = self.params
        return ALSConfig(
            rank=p.rank,
            num_iterations=p.num_iterations,
            lam=p.lam,
            seed=p.seed,
            implicit=p.implicit,
            alpha=p.alpha,
            weighted_lambda=p.weighted_lambda,
            gather_dtype=p.gather_dtype,
            gather_mode=p.gather_mode,
            solver=p.solver,
            fused_gather=p.fused_gather,
            solver_mode=p.solver_mode,
            subspace_size=p.subspace_size,
            factor_placement=p.factor_placement,
            coded_shards=p.coded_shards,
            retrieval=p.retrieval,
            candidate_factor=p.candidate_factor,
            nprobe=p.nprobe,
        )

    def _serve_dtype(self) -> Optional[str]:
        dt = self.params.serving_dtype
        return None if dt == "float32" else dt

    def _retrieval_config(self):
        """The two-stage retrieval config, or None when this algorithm
        serves the exact scan (the default)."""
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

    def train(self, ctx: WorkflowContext, data: TrainingData) -> ALSModel:
        cfg = self._config()
        sharded = cfg.factor_placement == "sharded"
        if data.coo_local:
            # each process kept its scan shard (coo: "local"): exchange
            # the triples straight to each row's owning shard
            if not sharded:
                raise ValueError(
                    "datasource coo='local' requires the algorithm side "
                    "to set factorPlacement='sharded' (the sharded-COO "
                    "layout); 'replicated' needs the gathered read"
                )
            from ..models.als import ALSTrainer

            factors = ALSTrainer.distributed(
                data.ratings, cfg=cfg, mesh=ctx.mesh,
                exchange_dir=ctx.storage.model_data_dir() / "_ingest",
                tag="als-coo",
            ).train()
        else:
            factors = train_als(data.ratings, cfg=cfg, device=ctx.device,
                                mesh=ctx.mesh if sharded else None)
        self.train_report = factors.report
        logger.info("ALS trained: %s", factors.report)
        return ALSModel(
            user_factors=factors.user_factors,
            item_factors=factors.item_factors,
            users=data.ratings.users,
            items=data.ratings.items,
            item_props=data.items,
            device=ctx.device,
        )

    # -- serving ----------------------------------------------------------
    def _allowed_mask(self, model: ALSModel, query: Query):
        """-inf additive host mask for filtered-out items; None when the
        query has no filters (the unbiased scorer is dispatched)."""
        return filter_bias_mask(
            model.items, model.item_props,
            categories=query.categories, whitelist=query.whitelist,
            blacklist=query.blacklist or (), none_if_empty=True,
        )

    def warmup(self, model: ALSModel, max_batch: int = 64) -> None:
        """Run the scorers once at the common shapes (solo ``num`` in
        1/4/10/20, masked and not; every pow2 batch up to ``max_batch``)
        so the first real query pays no one-time device set-up."""
        n = len(model.items)
        if n == 0:
            return
        table = model.device_item_factors(self._serve_dtype())
        rank = model.item_factors.shape[1]
        vec = torch.zeros(rank, dtype=torch.float32, device=model.device)
        bias = torch.zeros(n, dtype=torch.float32, device=model.device)
        for k in {min(k, n) for k in (1, 4, 10, 20)}:
            topk_scores(vec, table, k)
            topk_scores(vec, table, k, bias=bias)
        warm_batched_topk(
            model.device_item_factors_t(self._serve_dtype()), rank, n,
            unmasked_too=True, max_batch=max_batch,
        )
        rcfg = self._retrieval_config()
        if rcfg is not None:
            # the two-stage path joins the warm-up ladder: every pow2
            # batch the batcher can dispatch at the default num, and
            # the small-k solo shapes
            idx = model.device_ann_index(rcfg)
            k_default = min(pow2_ceil(10), n)
            idx.warm(k_default, pow2_ladder(max_batch) + [1], table)
            for k in {min(pow2_ceil(kk), n) for kk in (1, 4)}:
                idx.warm(k, [1], table)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        uix = model.users.get(query.user)
        if uix < 0 or query.num <= 0:
            return PredictedResult(item_scores=())
        k = min(query.num, len(model.items))
        mask = self._allowed_mask(model, query)
        table = model.device_item_factors(self._serve_dtype())
        uvec = torch.as_tensor(
            np.asarray(model.user_factors[uix], np.float32),
            device=model.device,
        )
        rcfg = self._retrieval_config()
        if mask is None and rcfg is not None:
            # quantized candidate shortlist -> exact f32 rerank; a
            # filtered query stays on the exact scorer (a -inf mask
            # over a shortlist could starve it below num)
            vals2, ixs2 = model.device_ann_index(rcfg).search(
                uvec[None, :], k, table)
            return PredictedResult(
                item_scores=decode_item_scores(model.items, vals2[0],
                                               ixs2[0])
            )
        bias = (None if mask is None
                else torch.as_tensor(mask, device=model.device))
        vals, ixs = topk_scores(uvec, table, k, bias=bias)
        return PredictedResult(
            item_scores=decode_item_scores(model.items, vals, ixs)
        )

    def batch_predict(self, model: ALSModel, queries: Sequence[Query]):
        """Eval + micro-batched serving path: ONE batched product for all
        queries, honoring the same per-query filters as :meth:`predict`.

        The device batch is ``len(queries)`` whatever the number of valid
        queries (invalid ones score a row-0 duplicate that is dropped on
        the host), and ``k`` is rounded up to a power of two, so the
        shapes the card sees stay few."""
        out: list[PredictedResult] = [
            PredictedResult(item_scores=()) for _ in queries
        ]
        uix = np.array(
            [model.users.get(q.user) for q in queries], dtype=np.int64
        )
        nums = np.array([q.num for q in queries], dtype=np.int64)
        valid = (uix >= 0) & (nums > 0)
        if not valid.any():
            return out
        n_items = len(model.items)
        k = min(pow2_ceil(int(nums[valid].max())), n_items)
        uvecs = torch.as_tensor(
            np.asarray(model.user_factors[np.where(valid, uix, 0)],
                       np.float32),
            device=model.device,
        )
        masks = [
            self._allowed_mask(model, q) if v else None
            for q, v in zip(queries, valid)
        ]
        mask = None
        if any(m is not None for m in masks):
            zero = np.zeros(n_items, dtype=np.float32)
            mask = torch.as_tensor(
                np.stack([zero if m is None else m for m in masks]),
                device=model.device,
            )
        rcfg = self._retrieval_config()
        if mask is None and rcfg is not None:
            # two-stage: a quantized shortlist scan and an exact rerank
            # of candidate_factor*k rows instead of the O(M*R) product
            vals, ixs = model.device_ann_index(rcfg).search(
                uvecs, k, model.device_item_factors(self._serve_dtype())
            )
        else:
            vals, ixs = batch_topk_scores_t(
                uvecs, model.device_item_factors_t(self._serve_dtype()),
                k, mask=mask,
            )
        decoded = decode_batch_item_scores(
            model.items, vals, ixs, [q.num for q in queries], valid, k
        )
        return [
            PredictedResult(item_scores=scores) for scores in decoded
        ]

    def predict_rating(self, model: ALSModel, user: str, item: str) -> float:
        """Point prediction for RMSE-style evaluation."""
        u = model.users.get(user)
        i = model.items.get(item)
        if u < 0 or i < 0:
            return float("nan")
        return float(model.user_factors[u] @ model.item_factors[i])


# --------------------------------------------------------------------------
# Engine factory
# --------------------------------------------------------------------------


class RecommendationServing(FirstServing):
    pass


def _validate_rec_params(ep) -> None:
    """Cross-component coupling: datasource ``coo: "local"`` hands each
    ALS algorithm a process-local shard, which only the sharded-COO
    layout can train; caught at config time, as the reference does."""
    ds = ep.data_source[1]
    if getattr(ds, "coo", "gathered") != "local":
        return
    bad = [
        name or "als"
        for name, p in ep.algorithms
        if getattr(p, "factor_placement", None) != "sharded"
    ]
    if bad:
        raise ValueError(
            "datasource coo='local' requires factorPlacement='sharded' "
            f"on every algorithm; offending: {bad} — 'replicated' "
            "placement needs the gathered read (coo='gathered')"
        )


def recommendation_engine() -> Engine:
    """`EngineFactory` analogue for the recommendation template."""
    return Engine(
        RecommendationDataSource,
        IdentityPreparator,
        {"als": ALSAlgorithm, "": ALSAlgorithm},
        RecommendationServing,
        params_validator=_validate_rec_params,
    )


# --------------------------------------------------------------------------
# Evaluation (k-fold MetricEvaluator over the recommendation engine)
# --------------------------------------------------------------------------


class RatingAlgorithm(ALSAlgorithm):
    """ALS variant whose predictions are point rating estimates — used by the
    RMSE evaluation where queries carry ``num=0`` and the actual is an
    :class:`ActualRating`."""

    def batch_predict(self, model: ALSModel, queries: Sequence[Query]):
        # during eval the actuals carry the item; the prediction for (user,
        # item) is the factor dot product.  We return the full user vector
        # index per query; the metric resolves the item side.
        return [RatingPrediction(model=model, user=q.user) for q in queries]

    def predict(self, model: ALSModel, query: Query):
        return RatingPrediction(model=model, user=query.user)


@dataclass(slots=True)
class RatingPrediction:
    model: ALSModel
    user: str


class RMSEMetric:
    """Root-mean-squared error over held-out ratings (lower is better).

    Works with :class:`RatingAlgorithm` predictions + :class:`ActualRating`
    actuals from ``read_eval``; the products are float32 over the model's
    host factors, the errors float64, as in the reference."""

    header = "RMSE"

    def calculate(self, ctx, data) -> float:
        sq, n = 0.0, 0
        for _, qpa in data:
            if not qpa:
                continue
            # one model per eval set: vectorize the gathers + dot products
            model = qpa[0][1].model
            u = model.users.encode([p.user for _, p, _ in qpa])
            i = model.items.encode([a.item for _, _, a in qpa])
            r = np.asarray([a.rating for _, _, a in qpa], dtype=np.float64)
            ok = (u >= 0) & (i >= 0)
            if not ok.any():
                continue
            pred = np.einsum(
                "nr,nr->n",
                model.user_factors[u[ok]],
                model.item_factors[i[ok]],
            )
            sq += float(((pred - r[ok]) ** 2).sum())
            n += int(ok.sum())
        return float(np.sqrt(sq / n)) if n else float("nan")

    def compare(self, a: float, b: float) -> int:
        if a == b:
            return 0
        return 1 if a < b else -1  # lower RMSE wins


def recommendation_evaluation():
    """Evaluation binding for sweeps over ALS hyperparameters.  Fold count
    comes from each candidate's ``DataSourceParams.eval_k``."""
    from ..controller import Evaluation

    engine = Engine(
        RecommendationDataSource,
        IdentityPreparator,
        {"als": RatingAlgorithm, "": RatingAlgorithm},
        RecommendationServing,
    )
    return Evaluation(engine, RMSEMetric())


def _conformance_events():
    """The conformance fixture's events (the reference's, field by
    field): rate events of 8 users over 10 items and a category
    ``$set`` per item."""
    from ..storage import DataMap, Event

    events = []
    for u in range(8):
        for j in range(4):
            i = (u + j * 3) % 10
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": float((u + i) % 5 + 1)}),
            ))
    for j in range(10):
        events.append(Event(
            event="$set", entity_type="item", entity_id=f"i{j}",
            properties=DataMap(
                {"categories": ["even" if j % 2 == 0 else "odd"]}),
        ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

recommendation_engine = engine_spec(
    "recommendation",
    description=(
        "Personalized recommendation via block-ALS on the GPU "
        "(scala-parallel-recommendation analogue)"
    ),
    default_params={
        "datasource": {
            "params": {"appName": "MyApp", "eventNames": ["rate", "buy"]}
        },
        "algorithms": [
            {
                "name": "als",
                "params": {"rank": 10, "numIterations": 20,
                           "lambda": 0.01, "seed": 3},
            }
        ],
    },
    query_example={"user": "1", "num": 4},
    evaluation=recommendation_evaluation,
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"user": "u1", "num": 3},),
        check=lambda r: len(r.get("itemScores", [])) >= 1,
        variant={
            # evalK 2: the suite's eval step runs a real 2-fold
            # read_eval for this engine (the others' eval dispatch
            # yields an empty set)
            "datasource": {"params": {"appName": "forge-conf",
                                      "eventNames": ["rate"],
                                      "evalK": 2}},
            "algorithms": [
                {"name": "als",
                 "params": {"rank": 4, "numIterations": 3,
                            "lambda": 0.1, "seed": 1}}
            ],
        },
    ),
)(recommendation_engine)
