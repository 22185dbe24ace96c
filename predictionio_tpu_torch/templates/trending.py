"""Trending-now engine — session/time-decayed event aggregation (port
of ``predictionio_tpu/templates/trending.py``).

A genuinely different data path from the ALS family: there is NO factor
model and NO device work anywhere.  Training is one scan over the event
store folding every qualifying event into an exponentially time-decayed
per-item weight (half-life configurable), and serving is a host-side
top-k over those weights.  Freshness comes from the same primitive
fold-in (``live/``) uses — ``find_rows_since`` watermark cursors — but
WITHOUT fold-in: the serving model re-scans from its own cursor on a
short cadence, so a burst of views moves the trending list within
``refreshSec`` of hitting the store.  On the sharded store
(`ShardedSQLiteEventStore`) the full-backlog scan is one unbounded
``find_rows_since(parallel=True)`` call over every shard (the port's
store walks the shards in turn: see its docstring).

Decay math: weights are stored in "reference time" space — an event at
epoch ``te`` contributes ``2 ** ((te - t0) / half_life)`` where ``t0``
is the model's reference epoch.  Ranking is invariant under the global
``2 ** ((t0 - now) / half_life)`` rescale, so re-scans just ADD new
events' weights; when the exponent range grows past ``_REBASE_EXP`` the
reference is re-based (all weights scaled down, ``t0`` advanced) so an
always-on deployment never overflows.

Failure semantics: a refresh that cannot read the store (chaos:
``storage.read`` fault point) serves the STALE trending list and books
``pio_resilience_events_total{kind="trending.stale_serve"}`` — stale
answers beat no answers, the same degradation contract as /reload.

Wire format: query ``{"num": 10, "blacklist": [...]}``; result
``{"itemScores": [{"item": ..., "score": ...}]}`` where score is the
decayed event count AT QUERY TIME (comparable across queries).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

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
from ..obs import RESILIENCE_TOTAL
from ..resilience import faults
from .recommendation import ItemScore, PredictedResult, _resolve_app_id

logger = logging.getLogger(__name__)

# rebase the reference epoch when the newest event's exponent exceeds
# this (2**60 headroom in f64 keeps sums exact to ~1 ulp)
_REBASE_EXP = 60.0


@dataclass(frozen=True)
class Query:
    num: int = 10
    blacklist: Optional[tuple[str, ...]] = None

    @staticmethod
    def from_json(d: dict) -> "Query":
        bl = d.get("blackList") or d.get("blacklist")
        return Query(
            num=int(d.get("num", 10)),
            blacklist=tuple(bl) if bl else None,
        )


@dataclass(frozen=True)
class TrendingDataSourceParams(Params):
    __param_aliases__ = {"halfLifeSec": "half_life_s",
                         "refreshSec": "refresh_s"}

    app_name: str = ""
    app_id: int = -1
    channel_id: int = 0
    event_names: tuple[str, ...] = ("view", "rate", "buy")
    # decay half-life: an event stops counting for half as much every
    # halfLifeSec (6h default — "trending today", not "popular ever")
    half_life_s: float = 21600.0
    # serving refresh cadence: predict re-scans from the cursor at most
    # every refreshSec (0 = every query; < 0 = never, train-time only)
    refresh_s: float = 2.0
    # page size for stores without a parallel scan
    scan_page: int = 50000
    # ranking eval: hold out the most recent evalHoldout fraction of
    # the event stream (a TIME split — trending forecasts the near
    # future, so shuffling would leak), rank MAP@evalNum against each
    # holdout user's future items
    eval_holdout: float = 0.0
    eval_num: int = 10

    def __post_init__(self) -> None:
        if self.half_life_s <= 0:
            raise ValueError(
                f"halfLifeSec must be > 0, got {self.half_life_s}"
            )
        if not 0.0 <= self.eval_holdout < 1.0:
            raise ValueError(
                f"evalHoldout must be in [0, 1), got {self.eval_holdout}"
            )


def scan_decayed(
    es, app_id: int, channel_id: int, cursor,
    event_names: Sequence[str], half_life_s: float, t0: float,
    page: int = 50000,
):
    """One incremental scan: fold rows past ``cursor`` into per-item
    decayed weights (reference-time space).  Returns
    ``(weights: dict[item, float], new_cursor, n_events)``.

    Uses RAW storage rows (``find_rows_since``) — column 6 is the
    target entity id, column 8 the event-time millis — so aggregation
    never pays full Event decode.  On a sharded store the scan is one
    unbounded call over every shard (``parallel=True``)."""
    weights: dict[str, float] = {}
    n = 0

    def fold(rows) -> None:
        nonlocal n
        for r in rows:
            item = r[6]
            if item is None:
                continue
            te = r[8] / 1000.0
            w = 2.0 ** ((te - t0) / half_life_s)
            weights[item] = weights.get(item, 0.0) + w
            n += 1

    if getattr(es, "supports_parallel_scan", False):
        rows, cursor = es.find_rows_since(
            app_id, channel_id, cursor=cursor,
            event_names=list(event_names), parallel=True,
        )
        fold(rows)
        return weights, cursor, n
    while True:
        rows, cursor = es.find_rows_since(
            app_id, channel_id, cursor=cursor, limit=page,
            event_names=list(event_names),
        )
        fold(rows)
        if len(rows) < page:
            return weights, cursor, n


@dataclass
class TrendingTrainingData:
    weights: dict[str, float]
    t0: float
    cursor: Any
    app_id: int
    n_events: int = 0

    def sanity_check(self) -> None:
        if not self.weights:
            raise ValueError(
                "no qualifying events found — is the app empty?"
            )


class TrendingDataSource(DataSource):
    """The training read IS the aggregation: one (parallel) cursor scan
    from the beginning of the window."""

    params_class = TrendingDataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrendingTrainingData:
        p: TrendingDataSourceParams = self.params
        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        t0 = time.time()  # reference EPOCH (timestamp, not a duration)
        weights, cursor, n = scan_decayed(
            es, app_id, p.channel_id, 0, p.event_names, p.half_life_s,
            t0, page=p.scan_page,
        )
        return TrendingTrainingData(
            weights=weights, t0=t0, cursor=cursor, app_id=app_id,
            n_events=n,
        )

    def read_eval(self, ctx: WorkflowContext):
        """Time-split ranking eval: train on the oldest
        ``1 - evalHoldout`` of the stream, score the trending list's
        MAP@k against each holdout user's FUTURE items.  One eval set;
        the trained model never refreshes during eval (the algorithms
        carry no serving context there), so the holdout cannot leak
        through the cursor re-scan."""
        p: TrendingDataSourceParams = self.params
        if p.eval_holdout <= 0:
            return []
        from ..controller.metrics import ActualItems

        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        evs = [
            e for e in es.find(
                app_id=app_id, channel_id=p.channel_id,
                event_names=list(p.event_names),
            )
            if e.target_entity_id
        ]
        evs.sort(key=lambda e: e.event_time)
        if len(evs) < 4:
            return []
        cut = min(
            max(int(len(evs) * (1.0 - p.eval_holdout)), 1),
            len(evs) - 1,
        )
        train, held = evs[:cut], evs[cut:]
        t0 = time.time()
        weights: dict[str, float] = {}
        for e in train:
            w = 2.0 ** (
                (e.event_time.timestamp() - t0) / p.half_life_s
            )
            weights[e.target_entity_id] = (
                weights.get(e.target_entity_id, 0.0) + w
            )
        td = TrendingTrainingData(
            weights=weights, t0=t0, cursor=0, app_id=app_id,
            n_events=len(train),
        )
        by_user: dict[str, set] = {}
        for e in held:
            by_user.setdefault(e.entity_id, set()).add(
                e.target_entity_id
            )
        qa = [
            (Query(num=p.eval_num),
             ActualItems(items=tuple(sorted(items))))
            for _user, items in sorted(by_user.items())
        ]
        return [(td, {"holdout": p.eval_holdout, "users": len(qa)}, qa)]


class TrendingModel:
    """Decayed per-item weights + the scan cursor that keeps them
    fresh.  All mutation happens under ``_lock``; readers snapshot the
    (ids, weights, t0) triple and rank outside it."""

    def __init__(self, item_ids: list[str], weights: np.ndarray,
                 t0: float, cursor, app_id: int, channel_id: int,
                 event_names: tuple[str, ...], half_life_s: float,
                 refresh_s: float, scan_page: int = 50000):
        self._lock = threading.Lock()
        self.item_ids = list(item_ids)
        self._ix = {i: n for n, i in enumerate(self.item_ids)}
        self.weights = np.asarray(weights, np.float64)
        self.t0 = float(t0)
        self.cursor = cursor
        self.app_id = int(app_id)
        self.channel_id = int(channel_id)
        self.event_names = tuple(event_names)
        self.half_life_s = float(half_life_s)
        self.refresh_s = float(refresh_s)
        self.scan_page = int(scan_page)
        self._last_refresh_mono = time.monotonic()
        self.stale = False
        self.refreshes = 0
        self.events_folded = 0

    @classmethod
    def from_training(cls, data: TrendingTrainingData,
                      p: "TrendingAlgorithmParams",
                      dp: TrendingDataSourceParams) -> "TrendingModel":
        ids = sorted(data.weights)
        w = np.asarray([data.weights[i] for i in ids], np.float64)
        return cls(
            ids, w, data.t0, data.cursor, data.app_id, dp.channel_id,
            dp.event_names, dp.half_life_s, dp.refresh_s, dp.scan_page,
        )

    # -- freshness: re-scan from the cursor -------------------------------
    def _merge_locked(self, add: dict[str, float], cursor) -> None:
        new_items = [i for i in add if i not in self._ix]
        if new_items:
            for i in new_items:
                self._ix[i] = len(self.item_ids)
                self.item_ids.append(i)
            self.weights = np.concatenate(
                [self.weights, np.zeros(len(new_items), np.float64)]
            )
        for item, w in add.items():
            self.weights[self._ix[item]] += w
        self.cursor = cursor
        # rebase before reference-space exponents overflow f64
        max_exp = math.log2(float(self.weights.max()) + 1e-300)
        if max_exp > _REBASE_EXP:
            now = time.time()
            self.weights = self.weights * (
                2.0 ** ((self.t0 - now) / self.half_life_s)
            )
            self.t0 = now

    def refresh(self, es, force: bool = False) -> int:
        """Fold events past the cursor into the live weights; returns
        the number folded.  Throttled to ``refresh_s`` unless forced;
        store failures (incl. the ``storage.read`` chaos point) leave
        the stale weights serving and mark :attr:`stale`."""
        if self.refresh_s < 0 and not force:
            return 0
        with self._lock:
            if not force and (
                time.monotonic() - self._last_refresh_mono
                < self.refresh_s
            ):
                return 0
            # claim the window under the lock so concurrent queries
            # don't pile up duplicate scans
            self._last_refresh_mono = time.monotonic()
            cursor = self.cursor
            t0 = self.t0
        try:
            faults.check("storage.read")
            add, new_cursor, n = scan_decayed(
                es, self.app_id, self.channel_id, cursor,
                self.event_names, self.half_life_s, t0,
                page=self.scan_page,
            )
        except Exception as e:
            RESILIENCE_TOTAL.labels(kind="trending.stale_serve").inc()
            with self._lock:
                self.stale = True
            logger.warning(
                "trending refresh failed (%s: %s); serving the stale "
                "list", type(e).__name__, e,
            )
            return 0
        with self._lock:
            if n:
                self._merge_locked(add, new_cursor)
                self.events_folded += n
            else:
                self.cursor = new_cursor
            self.stale = False
            self.refreshes += 1
        return n

    def top(self, k: int, blacklist=()) -> list[tuple[str, float]]:
        """Host-side top-k by decayed weight, scored at NOW."""
        with self._lock:
            ids = self.item_ids
            w = self.weights
            t0 = self.t0
        if not ids or k <= 0:
            return []
        scale = 2.0 ** ((t0 - time.time()) / self.half_life_s)
        if blacklist:
            bl = set(blacklist)
            keep = np.fromiter(
                (i not in bl for i in ids), bool, count=len(ids)
            )
            if not keep.any():
                return []
            w = np.where(keep, w, -np.inf)
        k = min(k, len(ids))
        part = np.argpartition(-w, k - 1)[:k]
        order = part[np.argsort(-w[part])]
        return [
            (ids[int(ix)], float(w[ix] * scale))
            for ix in order if np.isfinite(w[ix]) and w[ix] > 0
        ]


@dataclass(frozen=True)
class TrendingAlgorithmParams(Params):
    pass


class TrendingAlgorithm(Algorithm):
    """Aggregation passthrough: train adopts the DataSource's scan as
    the model; predict ranks host-side after a cursor refresh.  There
    is deliberately no ``batch_predict`` override — with no device call
    to coalesce, micro-batching would only add queue hops (the serving
    auto-batcher correctly stays off)."""

    params_class = TrendingAlgorithmParams
    placement = ModelPlacement.HOST

    def train(self, ctx: WorkflowContext,
              data: TrendingTrainingData) -> TrendingModel:
        # the DataSource params rode the training data implicitly via
        # the scan; recover the serving knobs from the engine params
        # attached to this component pipeline
        dp = self._datasource_params(ctx)
        return TrendingModel.from_training(data, self.params, dp)

    def _datasource_params(self, ctx) -> TrendingDataSourceParams:
        # the trained model needs the DataSource's scan knobs at SERVE
        # time (cursor refresh); they ride the WorkflowContext-free
        # path via a private attr the engine wiring sets — fall back to
        # defaults for direct library callers
        return getattr(self, "_ds_params", None) or \
            TrendingDataSourceParams()

    def _event_store(self):
        ctx = getattr(self, "_ctx", None)
        if ctx is None:
            return None
        return ctx.storage.get_event_store()

    def _maybe_refresh(self, model: TrendingModel,
                       force: bool = False) -> None:
        es = self._event_store()
        if es is not None:
            model.refresh(es, force=force)

    def warmup(self, model: TrendingModel, max_batch: int = 64) -> None:
        # no device executables to compile; prime one refresh so the
        # first query pays no scan
        self._maybe_refresh(model, force=True)

    def predict(self, model: TrendingModel, query: Query) -> PredictedResult:
        self._maybe_refresh(model)
        scores = model.top(query.num, blacklist=query.blacklist or ())
        return PredictedResult(item_scores=tuple(
            ItemScore(item=str(i), score=s) for i, s in scores
        ))

    # -- persistence (the model holds a lock; JSON round-trip instead
    # of the framework pickle) --------------------------------------------
    def save_model(self, ctx, model_id, model: TrendingModel, base_dir):
        import json as _json

        base_dir.mkdir(parents=True, exist_ok=True)
        with model._lock:
            doc = {
                "itemIds": model.item_ids,
                "weights": [float(x) for x in model.weights],
                "t0": model.t0,
                "cursor": model.cursor,
                "appId": model.app_id,
                "channelId": model.channel_id,
                "eventNames": list(model.event_names),
                "halfLifeSec": model.half_life_s,
                "refreshSec": model.refresh_s,
                "scanPage": model.scan_page,
            }
        path = base_dir / f"{model_id}-trending.json"
        path.write_text(_json.dumps(doc))
        return {"json": path.name}

    def load_model(self, ctx, model_id, manifest, base_dir):
        import json as _json

        doc = _json.loads((base_dir / manifest["json"]).read_text())
        return TrendingModel(
            doc["itemIds"], np.asarray(doc["weights"], np.float64),
            doc["t0"], doc["cursor"], doc["appId"], doc["channelId"],
            tuple(doc["eventNames"]), doc["halfLifeSec"],
            doc["refreshSec"], doc.get("scanPage", 50000),
        )


class _TrendingEngine(Engine):
    """Engine whose algorithm needs the DataSource params at serve time
    (the cursor-refresh knobs live there)."""

    def _algorithms(self, ep):
        algos = super()._algorithms(ep)
        ds_params = ep.data_source[1]
        if isinstance(ds_params, TrendingDataSourceParams):
            for a in algos:
                a._ds_params = ds_params
        return algos


def trending_engine() -> Engine:
    return _TrendingEngine(
        TrendingDataSource,
        IdentityPreparator,
        {"trending": TrendingAlgorithm, "": TrendingAlgorithm},
        FirstServing,
    )


def trending_evaluation(app_name: str = "MyApp", k: int = 10,
                        holdout: float = 0.2):
    """MAP@k evaluation binding: `eval --engine trending` scores the
    trending list against each holdout user's future items on a time
    split.  ``refreshSec=-1`` pins the eval
    model to its training window."""
    from ..controller import Evaluation
    from ..controller.metrics import MAPatK

    engine = trending_engine()
    ep = engine.params_from_variant({
        "datasource": {"params": {
            "appName": app_name, "refreshSec": -1.0,
            "evalHoldout": holdout, "evalNum": k,
        }},
        "algorithms": [{"name": "trending", "params": {}}],
    })
    return Evaluation(engine, MAPatK(k), engine_params_list=[ep])


# -- pio-forge registration -------------------------------------------------


def _conformance_events():
    from ..storage import Event

    events = []
    # "hot" gets 10 recent views, the rest 1-2 — the trending list's
    # head is deterministic
    for n in range(10):
        events.append(Event(
            event="view", entity_type="user", entity_id=f"u{n}",
            target_entity_type="item", target_entity_id="hot",
        ))
    for j in range(5):
        events.append(Event(
            event="view", entity_type="user", entity_id=f"u{j}",
            target_entity_type="item", target_entity_id=f"cold{j}",
        ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

trending_engine = engine_spec(
    "trending",
    description=(
        "Trending-now: time-decayed event aggregation served straight "
        "from event-store cursor scans (no factor model, no device)"
    ),
    default_params={
        "datasource": {
            "params": {"appName": "MyApp",
                       "eventNames": ["view", "rate", "buy"],
                       "halfLifeSec": 21600.0, "refreshSec": 2.0}
        },
        "algorithms": [{"name": "trending", "params": {}}],
    },
    query_example={"num": 10},
    evaluation=trending_evaluation,
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"num": 3},),
        check=lambda r: bool(r.get("itemScores"))
        and r["itemScores"][0]["item"] == "hot",
        variant={
            "datasource": {"params": {"appName": "forge-conf",
                                      "eventNames": ["view"],
                                      "refreshSec": 0.0}},
            "algorithms": [{"name": "trending", "params": {}}],
        },
    ),
)(trending_engine)
