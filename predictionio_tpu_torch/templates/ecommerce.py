"""E-commerce recommendation engine template.

Port of ``predictionio_tpu/templates/ecommerce.py`` (PredictionIO's
scala-parallel-ecommercerecommendation, ``ECommAlgorithm``): implicit ALS
over view events (or rate events through ``ratingProperty``), with
predict-time event-store reads — the serving path reads from the live
event store

* the user's already-seen items (``unseenOnly`` and ``seenEvents``,
  reference `ALSAlgorithm.scala:160-192`), and
* the latest ``$set`` on the ``constraint``/``unavailableItems`` entity
  (reference `:194-215`),

and merges both with the query's black list before the top-k product on
the card.  Either read that fails logs the error and filters nothing,
as the reference does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional

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
from ..models.als import train_als
from ..ops.topk import batch_topk_scores_t, pow2_ceil, topk_scores
from ._common import DeviceTableMixin, filter_bias_mask, warm_batched_topk
from .recommendation import (
    PredictedResult,
    Query,
    _resolve_app_id,
    decode_batch_item_scores,
    decode_item_scores,
)
from .similarproduct import _implicit_config, _scaling_options

logger = logging.getLogger(__name__)

__all__ = [
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommDataSource",
    "ECommDataSourceParams",
    "ECommModel",
    "ECommTrainingData",
    "ecommerce_engine",
]


@dataclass(frozen=True)
class ECommDataSourceParams(Params):
    app_name: str = ""
    app_id: int = -1
    view_events: tuple[str, ...] = ("view",)
    rating_property: Optional[str] = None  # train-with-rate-event variant


@dataclass
class ECommTrainingData:
    ratings: Any
    items: dict[str, dict]
    app_id: int = -1

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError("no view events found")


class ECommDataSource(DataSource):
    params_class = ECommDataSourceParams

    def read_training(self, ctx: WorkflowContext) -> ECommTrainingData:
        p = self.params
        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        dedup = "last" if p.rating_property else "sum"
        if hasattr(es, "find_ratings"):
            # the SQLite stores' native read (explicit, or the
            # implicit-count mode without a rating property)
            ratings = es.find_ratings(
                app_id=app_id, event_names=p.view_events,
                rating_property=p.rating_property, dedup=dedup,
                entity_type="user",
            )
        else:
            frame = es.find_columnar(
                app_id=app_id, entity_type="user",
                event_names=list(p.view_events),
                float_property=p.rating_property,
                minimal=True,   # only to_ratings fields are consumed
            )
            ratings = frame.to_ratings(
                rating_property=p.rating_property, dedup=dedup,
            )
        items = {
            k: dict(v.fields)
            for k, v in es.aggregate_properties_of(
                app_id=app_id, entity_type="item"
            ).items()
        }
        return ECommTrainingData(ratings=ratings, items=items, app_id=app_id)


@dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    __param_aliases__ = {"lambda": "lam"}

    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    # the trainer's options (models/als.py): "pallas" and "fused" launch
    # their CUDA kernel on the card or raise; they never fall back
    solver: str = "xla"
    fused_gather: str = "auto"
    solver_mode: str = "full"
    subspace_size: int = 16
    factor_placement: str = "replicated"
    gather_dtype: str = "float32"
    gather_mode: str = "row"
    unseen_only: bool = False
    seen_events: tuple[str, ...] = ("view", "buy")


@dataclass
class ECommModel(DeviceTableMixin):
    user_factors: np.ndarray
    item_factors: np.ndarray
    users: Any
    items: Any
    item_props: dict[str, dict]
    app_id: int
    device: torch.device = torch.device("cuda")


class ECommAlgorithm(Algorithm):
    """Implicit ALS, served with the predict-time event-store filters."""

    params_class = ECommAlgorithmParams
    placement = ModelPlacement.DEVICE_SHARDED

    def train(self, ctx: WorkflowContext,
              data: ECommTrainingData) -> ECommModel:
        p = self.params
        factors = train_als(
            data.ratings, cfg=_implicit_config(p, **_scaling_options(p)),
            device=ctx.device,
        )
        self._ctx = ctx  # predict-time event-store access
        return ECommModel(
            user_factors=factors.user_factors,
            item_factors=factors.item_factors,
            users=data.ratings.users,
            items=data.ratings.items,
            item_props=data.items,
            app_id=data.app_id,
            device=ctx.device,
        )

    # -- predict-time event store reads ------------------------------------
    def _event_store(self):
        ctx = getattr(self, "_ctx", None)
        if ctx is None:
            from ..storage.registry import get_storage

            return get_storage().get_event_store()
        return ctx.storage.get_event_store()

    def _seen_items(self, model: ECommModel, user: str) -> set[str]:
        """The user's already-seen items (reference `:160-192`)."""
        p = self.params
        try:
            events = self._event_store().find(
                app_id=model.app_id,
                entity_type="user",
                entity_id=user,
                event_names=list(p.seen_events),
            )
            return {
                e.target_entity_id for e in events if e.target_entity_id
            }
        except Exception as e:
            logger.error("error reading seen events: %s", e)
            return set()

    def _unavailable_items(self, model: ECommModel) -> set[str]:
        """Latest constraint/unavailableItems $set (reference `:194-215`)."""
        try:
            pm = self._event_store().aggregate_properties_single_entity(
                app_id=model.app_id,
                entity_type="constraint",
                entity_id="unavailableItems",
            )
            if pm is None:
                return set()
            return set(pm.get_string_list("items"))
        except Exception as e:
            logger.error("error reading unavailableItems: %s", e)
            return set()

    def warmup(self, model: ECommModel, max_batch: int = 64) -> None:
        """Run the biased scorer once at the common ``num`` values (every
        query carries a filter mask), solo and at every pow2 batch the
        serving batcher can dispatch."""
        n = len(model.items)
        if n == 0:
            return
        table = model.device_item_factors()
        rank = model.item_factors.shape[1]
        vec = torch.zeros(rank, dtype=torch.float32, device=model.device)
        bias = torch.zeros(n, dtype=torch.float32, device=model.device)
        for k in {min(k, n) for k in (1, 4, 10, 20)}:
            topk_scores(vec, table, k, bias=bias)
        warm_batched_topk(model.device_item_factors_t(), rank, n,
                          max_batch=max_batch)

    def _query_mask(self, model: ECommModel, query: Query,
                    unavailable: Optional[set] = None):
        """The serve-time filter of one query: its black list, the
        user's seen items read from the live event store (with
        ``unseenOnly``) and the unavailable-items constraint.
        ``unavailable`` lets batch_predict read the constraint entity
        once a batch instead of once a query."""
        black = set(query.blacklist or ())
        if self.params.unseen_only:
            black |= self._seen_items(model, query.user)
        black |= (
            self._unavailable_items(model)
            if unavailable is None else unavailable
        )
        return filter_bias_mask(
            model.items, model.item_props,
            categories=query.categories, whitelist=query.whitelist,
            blacklist=black,
        )

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        uix = model.users.get(query.user)
        if uix < 0 or query.num <= 0:
            return PredictedResult(item_scores=())
        mask = self._query_mask(model, query)
        k = min(query.num, len(model.items))
        vals, ixs = topk_scores(
            torch.as_tensor(np.asarray(model.user_factors[uix], np.float32),
                            device=model.device),
            model.device_item_factors(), k,
            bias=torch.as_tensor(mask, device=model.device),
        )
        return PredictedResult(
            item_scores=decode_item_scores(model.items, vals, ixs)
        )

    def batch_predict(self, model: ECommModel, queries):
        """Micro-batched serving and eval: the per-query event-store
        reads stay host work, the scoring is one batched masked product
        (device batch ``len(queries)``, k rounded up to a power of
        two)."""
        out = [PredictedResult(item_scores=()) for _ in queries]
        n = len(model.items)
        if n == 0 or not queries:
            return out
        uix = np.array(
            [model.users.get(q.user) for q in queries], dtype=np.int64
        )
        nums = np.array([q.num for q in queries], dtype=np.int64)
        valid = (uix >= 0) & (nums > 0)
        if not valid.any():
            return out
        masks = np.zeros((len(queries), n), np.float32)
        unavailable = self._unavailable_items(model)  # batch-invariant
        for bi, q in enumerate(queries):
            if valid[bi]:
                masks[bi] = self._query_mask(model, q, unavailable)
        k = min(pow2_ceil(int(nums[valid].max())), n)
        uvecs = np.asarray(
            model.user_factors[np.where(valid, uix, 0)], np.float32
        )
        vals, ixs = batch_topk_scores_t(
            torch.as_tensor(uvecs, device=model.device),
            model.device_item_factors_t(), k,
            mask=torch.as_tensor(masks, device=model.device),
        )
        decoded = decode_batch_item_scores(
            model.items, vals, ixs, [q.num for q in queries], valid, k
        )
        return [PredictedResult(item_scores=s) for s in decoded]


def ecommerce_engine() -> Engine:
    return Engine(
        ECommDataSource,
        IdentityPreparator,
        {"ecomm": ECommAlgorithm, "": ECommAlgorithm},
        FirstServing,
    )


# -- registration --------------------------------------------------------


def _conformance_events():
    """View events of 10 users over 8 items: the reference fixture's."""
    from ..storage import Event

    events = []
    for u in range(10):
        for j in range(4):
            i = (u * 3 + j) % 8
            events.append(Event(
                event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
            ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

ecommerce_engine = engine_spec(
    "ecommercerecommendation",
    description=(
        "E-commerce recommendation with serving-time event filtering "
        "(scala-parallel-ecommercerecommendation analogue)"
    ),
    default_params={
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {
                "name": "ecomm",
                # the reference's default also names "appName" here,
                # which ECommAlgorithmParams refuses: the data source's
                # appName is the one read
                "params": {
                    "unseenOnly": True,
                    "seenEvents": ["buy", "view"],
                    "rank": 10,
                    "numIterations": 20,
                    "lambda": 0.01,
                    "seed": 3,
                },
            }
        ],
    },
    query_example={"user": "u1", "num": 4},
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"user": "u1", "num": 3},),
        check=lambda r: len(r.get("itemScores", [])) >= 1,
        variant={
            "datasource": {"params": {"appName": "forge-conf"}},
            "algorithms": [
                {"name": "ecomm",
                 "params": {"rank": 4, "numIterations": 3,
                            "lambda": 0.1, "alpha": 10.0, "seed": 1}}
            ],
        },
    ),
)(ecommerce_engine)
