"""Similar-product engine template.

Port of ``predictionio_tpu/templates/similarproduct.py`` (PredictionIO's
scala-parallel-similarproduct, with the ``multi`` variant's persistent
model): implicit-feedback ALS over view events (the port's
:func:`~predictionio_tpu_torch.models.als.train_als`, through the CUDA
kernels for ``solver="pallas"``/``"fused"``), then item-item cosine
ranking — the query items' rows of the row-normalized item table
averaged, scored against the table with one product and a top-k.

The model is saved as one ``.npz`` (the item table, its ids and a
normalized-table marker) and a JSON file of item properties, the
reference's custom ``PersistentModel`` format.
"""

from __future__ import annotations

import json
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
from ..models.als import ALSConfig, train_als
from ..ops.topk import batch_topk_scores_t, pow2_ceil, topk_scores
from ._common import (
    DeviceTableMixin,
    filter_bias_mask,
    normalize_rows,
    warm_batched_topk,
)
from .recommendation import (
    PredictedResult,
    _resolve_app_id,
    decode_batch_item_scores,
    decode_item_scores,
)

__all__ = [
    "Query",
    "SimilarALSModel",
    "SimilarALSParams",
    "SimilarDataSourceParams",
    "SimilarProductAlgorithm",
    "SimilarProductDataSource",
    "SimilarTrainingData",
    "similarproduct_engine",
]


@dataclass(frozen=True)
class Query:
    items: tuple[str, ...]
    num: int = 10
    categories: Optional[tuple[str, ...]] = None
    whitelist: Optional[tuple[str, ...]] = None
    blacklist: Optional[tuple[str, ...]] = None

    @staticmethod
    def from_json(d: dict) -> "Query":
        return Query(
            items=tuple(d["items"]),
            num=int(d.get("num", 10)),
            categories=tuple(d["categories"]) if d.get("categories") else None,
            whitelist=tuple(d.get("whiteList") or d.get("whitelist") or ())
            or None,
            blacklist=tuple(d.get("blackList") or d.get("blacklist") or ())
            or None,
        )


@dataclass(frozen=True)
class SimilarDataSourceParams(Params):
    app_name: str = ""
    app_id: int = -1
    view_events: tuple[str, ...] = ("view",)
    # ranking eval: hold out a seeded evalHoldout fraction of each
    # user's co-viewed items, query with one kept item, score MAP@evalNum
    # against the held-out set
    eval_holdout: float = 0.0
    eval_num: int = 10
    eval_seed: int = 7

    def __post_init__(self) -> None:
        if not 0.0 <= self.eval_holdout < 1.0:
            raise ValueError(
                f"evalHoldout must be in [0, 1), got {self.eval_holdout}"
            )


@dataclass
class SimilarTrainingData:
    ratings: Any  # implicit view-count Ratings
    items: dict[str, dict]

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError("no view events found")


class SimilarProductDataSource(DataSource):
    params_class = SimilarDataSourceParams

    def read_training(self, ctx: WorkflowContext) -> SimilarTrainingData:
        p = self.params
        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        if hasattr(es, "find_ratings"):
            # the SQLite stores' native read, counting view events per
            # (user, item) pair
            ratings = es.find_ratings(
                app_id=app_id, event_names=p.view_events,
                rating_property=None, dedup="sum", entity_type="user",
            )
        else:
            frame = es.find_columnar(
                app_id=app_id, entity_type="user",
                event_names=list(p.view_events),
                minimal=True,   # only to_ratings fields are consumed
            )
            ratings = frame.to_ratings(dedup="sum")  # implicit counts
        items = {
            k: dict(v.fields)
            for k, v in es.aggregate_properties_of(
                app_id=app_id, entity_type="item"
            ).items()
        }
        return SimilarTrainingData(ratings=ratings, items=items)

    def read_eval(self, ctx: WorkflowContext):
        """Leave-some-out co-view split: for each user with two or more
        distinct items, a seeded ``evalHoldout`` fraction of their
        (user, item) pairs is held out of training; the query anchors on
        one kept item and the held-out items are the relevant set MAP@k
        scores against.  Shared by the similarproduct and itemsimilarity
        engines (the same data source)."""
        p: SimilarDataSourceParams = self.params
        if p.eval_holdout <= 0:
            return []
        from ..controller.metrics import ActualItems
        from ..storage.columnar import Ratings

        data = self.read_training(ctx)
        ratings = data.ratings
        rng = np.random.default_rng(p.eval_seed)
        hold_mask = np.zeros(len(ratings), bool)
        by_user: dict[int, list[int]] = {}
        for pos, u in enumerate(ratings.user_ix):
            by_user.setdefault(int(u), []).append(pos)
        qa = []
        for _u, positions in sorted(by_user.items()):
            if len(positions) < 2:
                continue
            k_hold = min(
                max(int(round(len(positions) * p.eval_holdout)), 1),
                len(positions) - 1,
            )
            perm = rng.permutation(len(positions))
            held = [positions[i] for i in perm[:k_hold]]
            kept = [positions[i] for i in perm[k_hold:]]
            hold_mask[held] = True
            anchor = str(ratings.items.id_of(int(ratings.item_ix[kept[0]])))
            actual = tuple(sorted(
                str(ratings.items.id_of(int(ratings.item_ix[h])))
                for h in held
            ))
            qa.append((
                Query(items=(anchor,), num=p.eval_num),
                ActualItems(items=actual),
            ))
        if not qa:
            return []
        keep = ~hold_mask
        train = Ratings(
            user_ix=ratings.user_ix[keep],
            item_ix=ratings.item_ix[keep],
            rating=ratings.rating[keep],
            users=ratings.users,
            items=ratings.items,
        )
        td = SimilarTrainingData(ratings=train, items=data.items)
        return [(td, {"holdout": p.eval_holdout, "users": len(qa)}, qa)]


@dataclass(frozen=True)
class SimilarALSParams(Params):
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


@dataclass
class SimilarALSModel(DeviceTableMixin):
    """``item_factors`` is row-normalized at train time: inner product
    over the stored table is cosine, so scoring needs no per-query table
    normalization and the table serves the two-stage retrievers as is.
    ``.npz`` files saved without the normalized marker (raw factors) are
    normalized once at load."""

    item_factors: np.ndarray
    items: Any  # StringIndex
    item_props: dict[str, dict]
    device: torch.device = torch.device("cuda")


def _implicit_config(p, **extra) -> ALSConfig:
    """The implicit-feedback trainer config of an engine's ALS params
    (similarproduct's, ecommerce's and itemsimilarity's share the
    names)."""
    return ALSConfig(
        rank=p.rank, num_iterations=p.num_iterations, lam=p.lam,
        implicit=True, alpha=p.alpha, seed=p.seed, solver=p.solver,
        factor_placement=p.factor_placement, **extra,
    )


def _scaling_options(p) -> dict:
    """The trainer's scaling keys of similarproduct's and ecommerce's
    params (itemsimilarity's params do not carry them)."""
    return dict(
        fused_gather=p.fused_gather, solver_mode=p.solver_mode,
        subspace_size=p.subspace_size, gather_dtype=p.gather_dtype,
        gather_mode=p.gather_mode,
    )


class SimilarProductAlgorithm(Algorithm):
    """Implicit ALS -> item-item cosine
    (reference `similarproduct/multi/.../ALSAlgorithm.scala:70-200`)."""

    params_class = SimilarALSParams
    placement = ModelPlacement.DEVICE_SHARDED

    def train(self, ctx: WorkflowContext, data: SimilarTrainingData):
        p = self.params
        factors = train_als(
            data.ratings, cfg=_implicit_config(p, **_scaling_options(p)),
            device=ctx.device,
        )
        return SimilarALSModel(
            item_factors=normalize_rows(factors.item_factors),
            items=data.ratings.items,
            item_props=data.items,
            device=ctx.device,
        )

    # -- custom persistence ------------------------------------------------
    def save_model(self, ctx, model_id, model: SimilarALSModel, base_dir):
        base_dir.mkdir(parents=True, exist_ok=True)
        path = base_dir / f"{model_id}-similar.npz"
        np.savez_compressed(
            path,
            item_factors=model.item_factors,
            item_ids=model.items.ids.astype(str),
            # the normalized-table marker: load_model normalizes a file
            # saved without it (raw factors) exactly once
            normalized=np.array(True),
        )
        props_path = base_dir / f"{model_id}-props.json"
        props_path.write_text(json.dumps(model.item_props))
        return {"npz": path.name, "props": props_path.name}

    def load_model(self, ctx, model_id, manifest, base_dir):
        from ..storage.bimap import StringIndex

        with np.load(base_dir / manifest["npz"], allow_pickle=False) as data:
            factors = data["item_factors"]
            normalized = ("normalized" in data.files
                          and bool(data["normalized"]))
            ids = list(data["item_ids"])
        props = json.loads((base_dir / manifest["props"]).read_text())
        if not normalized:
            factors = normalize_rows(factors)
        return SimilarALSModel(
            item_factors=factors,
            items=StringIndex(ids),
            item_props=props,
            device=ctx.device,
        )

    # -- serving -----------------------------------------------------------
    def warmup(self, model: SimilarALSModel, max_batch: int = 64) -> None:
        """Run the cosine scorer once at the common ``num`` values, solo
        and at every pow2 batch the serving batcher can dispatch, so the
        first real query pays no one-time device set-up."""
        n = len(model.items)
        if n == 0:
            return
        tn = model.device_item_factors()
        rank = model.item_factors.shape[1]
        vec = torch.zeros(rank, dtype=torch.float32, device=model.device)
        bias = torch.zeros(n, dtype=torch.float32, device=model.device)
        for k in {min(k, n) for k in (1, 4, 10, 20)}:
            topk_scores(vec, tn, k, bias=bias)
        warm_batched_topk(model.device_item_factors_t(), rank, n,
                          max_batch=max_batch)

    def _query_vec_and_mask(self, model: SimilarALSModel, query: Query):
        """Per-query host work of predict and batch_predict: the mean of
        the known query items' (unit-norm) rows, normalized again, and
        the filter mask, which also excludes the query items.  Returns
        (None, None) for an unanswerable query."""
        known = [model.items.get(i) for i in query.items]
        known = [i for i in known if i >= 0]
        if not known or query.num <= 0:
            return None, None
        qvec = model.item_factors[known].mean(axis=0)
        qn = qvec / (np.linalg.norm(qvec) + 1e-9)
        mask = filter_bias_mask(
            model.items, model.item_props,
            categories=query.categories, whitelist=query.whitelist,
            blacklist=query.blacklist or (), exclude_ix=known,
        )
        return np.asarray(qn, np.float32), mask

    def predict(self, model: SimilarALSModel, query: Query) -> PredictedResult:
        qn, mask = self._query_vec_and_mask(model, query)
        if qn is None:
            return PredictedResult(item_scores=())
        k = min(query.num, len(model.items))
        vals, ixs = topk_scores(
            torch.as_tensor(qn, device=model.device),
            model.device_item_factors(), k,
            bias=torch.as_tensor(mask, device=model.device),
        )
        return PredictedResult(
            item_scores=decode_item_scores(model.items, vals, ixs)
        )

    def batch_predict(self, model: SimilarALSModel, queries):
        """Eval and micro-batched serving: one batched cosine product for
        the whole query set.  The device batch stays ``len(queries)``
        (an unanswerable query scores a zero vector, dropped on the
        host) and k rounds up to a power of two, so the shapes the card
        sees stay few."""
        out = [PredictedResult(item_scores=()) for _ in queries]
        n = len(model.items)
        if n == 0 or not queries:
            return out
        rank = model.item_factors.shape[1]
        qvecs = np.zeros((len(queries), rank), np.float32)
        masks = np.zeros((len(queries), n), np.float32)
        valid = np.zeros(len(queries), bool)
        for bi, q in enumerate(queries):
            qn, mask = self._query_vec_and_mask(model, q)
            if qn is None:
                continue
            valid[bi] = True
            qvecs[bi] = qn
            masks[bi] = mask
        if not valid.any():
            return out
        k = min(
            pow2_ceil(max(q.num for q, v in zip(queries, valid) if v)), n
        )
        vals, ixs = batch_topk_scores_t(
            torch.as_tensor(qvecs, device=model.device),
            model.device_item_factors_t(), k,
            mask=torch.as_tensor(masks, device=model.device),
        )
        decoded = decode_batch_item_scores(
            model.items, vals, ixs, [q.num for q in queries], valid, k
        )
        return [PredictedResult(item_scores=s) for s in decoded]


def similarproduct_engine() -> Engine:
    return Engine(
        SimilarProductDataSource,
        IdentityPreparator,
        {"als": SimilarProductAlgorithm, "": SimilarProductAlgorithm},
        FirstServing,
    )


# -- registration --------------------------------------------------------


def _conformance_events():
    """Two co-view clusters (even and odd items) and a category ``$set``
    per item: the reference fixture's events."""
    from ..storage import DataMap, Event

    events = []
    for u in range(12):
        cluster = u % 2
        for j in range(5):
            i = (2 * j + cluster) % 10
            events.append(Event(
                event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
            ))
    for j in range(10):
        events.append(Event(
            event="$set", entity_type="item", entity_id=f"i{j}",
            properties=DataMap(
                {"categories": ["even" if j % 2 == 0 else "odd"]}),
        ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

similarproduct_engine = engine_spec(
    "similarproduct",
    description=(
        "Similar-product ranking from item factors "
        "(scala-parallel-similarproduct analogue)"
    ),
    default_params={
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {
                "name": "als",
                "params": {"rank": 10, "numIterations": 20,
                           "lambda": 0.01, "seed": 3},
            }
        ],
    },
    query_example={"items": ["1"], "num": 4},
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"items": ["i0"], "num": 3},),
        check=lambda r: len(r.get("itemScores", [])) >= 1
        and all(s["item"] != "i0" for s in r["itemScores"]),
        variant={
            "datasource": {"params": {"appName": "forge-conf"}},
            "algorithms": [
                {"name": "als",
                 "params": {"rank": 4, "numIterations": 3,
                            "lambda": 0.1, "alpha": 10.0, "seed": 1}}
            ],
        },
    ),
)(similarproduct_engine)
