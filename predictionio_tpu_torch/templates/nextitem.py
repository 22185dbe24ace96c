"""Next-item engine — Markov session transitions (port of
``predictionio_tpu/templates/nextitem.py``).

The reference's ``e2`` module ships a ``markov_chain`` example; this is
its incremental-serving reproduction.  Training is one scan over the
event store feeding a gap-based :class:`~..sessions.Sessionizer` whose
transitions fold into a decayed CSR
:class:`~..sessions.TransitionStore`; serving answers "what comes after
item X" with the store's top-K successors.  Freshness uses pio-live's
primitive WITHOUT retraining: the serving model re-scans
``find_rows_since`` from its own watermark cursor on a short cadence,
carrying the sessionizer's per-user state across scans so a transition
spanning two scans still counts exactly once (idempotent-replay
contract — replaying from the saved cursor adds nothing).

Decay is trending's half-life idiom (reference-time space + rebase):
stale transitions age out, so last quarter's navigation paths stop
outranking this week's.

Unlike trending, this algorithm DOES override ``batch_predict`` — a
coalesced batch pays ONE cursor refresh and one store snapshot for the
whole flight, so the serving auto-batcher turns on for nextitem.

Wire format: query ``{"user": "u1", "item": "a", "num": 5,
"blacklist": [...]}`` — ``item`` anchors the lookup; when omitted the
engine falls back to the user's last seen item from the live session
state.  Result ``{"itemScores": [{"item": ..., "score": ...}]}`` where
score is the decayed transition count AT QUERY TIME.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

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
from ..obs import RESILIENCE_TOTAL, SESSION_EVENTS_TOTAL, SESSION_TRANSITIONS
from ..resilience import faults
from ..sessions import Sessionizer, TransitionStore, sessionize
from .recommendation import ItemScore, PredictedResult, _resolve_app_id

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Query:
    user: Optional[str] = None
    item: Optional[str] = None
    num: int = 10
    blacklist: Optional[tuple[str, ...]] = None

    @staticmethod
    def from_json(d: dict) -> "Query":
        bl = d.get("blackList") or d.get("blacklist")
        return Query(
            user=(str(d["user"]) if d.get("user") is not None else None),
            item=(str(d["item"]) if d.get("item") is not None else None),
            num=int(d.get("num", 10)),
            blacklist=tuple(bl) if bl else None,
        )


@dataclass(frozen=True)
class NextItemDataSourceParams(Params):
    __param_aliases__ = {"sessionGapSec": "gap_s",
                         "halfLifeSec": "half_life_s",
                         "refreshSec": "refresh_s"}

    app_name: str = ""
    app_id: int = -1
    channel_id: int = 0
    event_names: tuple[str, ...] = ("view", "rate", "buy")
    # session boundary: a forward gap longer than this starts a new
    # session (30 min — the classic web-analytics default)
    gap_s: float = 1800.0
    # transition decay half-life (7 days — navigation paths go stale
    # slower than trending counts)
    half_life_s: float = 604800.0
    # serving refresh cadence (same contract as trending: 0 = every
    # query, < 0 = never, train-time only)
    refresh_s: float = 2.0
    scan_page: int = 50000
    # time-split ranking eval: hold out the most recent evalHoldout
    # fraction of the stream, predict each held-out session's next
    # items from its first item
    eval_holdout: float = 0.0
    eval_num: int = 10

    def __post_init__(self) -> None:
        if self.gap_s <= 0:
            raise ValueError(f"sessionGapSec must be > 0, got {self.gap_s}")
        if self.half_life_s <= 0:
            raise ValueError(
                f"halfLifeSec must be > 0, got {self.half_life_s}"
            )
        if not 0.0 <= self.eval_holdout < 1.0:
            raise ValueError(
                f"evalHoldout must be in [0, 1), got {self.eval_holdout}"
            )


def scan_transitions(
    es, app_id: int, channel_id: int, cursor,
    event_names: Sequence[str], sessionizer: Sessionizer,
    store: TransitionStore, page: int = 50000,
):
    """One incremental scan: feed rows past ``cursor`` through the
    sessionizer into the transition store.  Returns ``(new_cursor,
    n_events, n_transitions)``.

    Raw rows (``find_rows_since``): column 4 is the acting entity id
    (user), 6 the target entity id (item), 8 the event-time millis.
    Each page is sorted by event time before feeding — a sharded scan
    interleaves shard rowid order, and sessionization is
    order-sensitive; residual cross-page disorder is absorbed by the
    sessionizer's backward-tolerant clock."""
    n_events = 0
    n_trans = 0

    def fold(rows) -> None:
        nonlocal n_events, n_trans
        batch = []
        for r in rows:
            if r[4] is None or r[6] is None:
                continue
            batch.append((r[8] / 1000.0, str(r[4]), str(r[6])))
        batch.sort()
        trans = []
        for te, user, item in batch:
            t = sessionizer.feed(user, item, te)
            if t is not None:
                trans.append((t[0], t[1], te))
        n_events += len(batch)
        n_trans += store.add_many(trans)

    if getattr(es, "supports_parallel_scan", False):
        rows, cursor = es.find_rows_since(
            app_id, channel_id, cursor=cursor,
            event_names=list(event_names), parallel=True,
        )
        fold(rows)
        return cursor, n_events, n_trans
    while True:
        rows, cursor = es.find_rows_since(
            app_id, channel_id, cursor=cursor, limit=page,
            event_names=list(event_names),
        )
        fold(rows)
        if len(rows) < page:
            return cursor, n_events, n_trans


@dataclass
class NextItemTrainingData:
    store: TransitionStore
    sessionizer: Sessionizer
    cursor: Any
    app_id: int
    n_events: int = 0

    def sanity_check(self) -> None:
        if not self.n_events:
            raise ValueError(
                "no qualifying events found — is the app empty?"
            )


class NextItemDataSource(DataSource):
    """The training read IS the sessionized aggregation: one cursor
    scan from the beginning of the stream."""

    params_class = NextItemDataSourceParams

    def read_training(self, ctx: WorkflowContext) -> NextItemTrainingData:
        p: NextItemDataSourceParams = self.params
        app_id = _resolve_app_id(ctx, p)
        es = ctx.storage.get_event_store()
        sessionizer = Sessionizer(gap_s=p.gap_s)
        store = TransitionStore(half_life_s=p.half_life_s)
        cursor, n, _ = scan_transitions(
            es, app_id, p.channel_id, 0, p.event_names, sessionizer,
            store, page=p.scan_page,
        )
        return NextItemTrainingData(
            store=store, sessionizer=sessionizer, cursor=cursor,
            app_id=app_id, n_events=n,
        )

    def read_eval(self, ctx: WorkflowContext):
        """Time-split session eval: train on the oldest
        ``1 - evalHoldout`` of the stream, then for each HELD-OUT
        session predict its follow-on items from its first item
        (MAP@evalNum).  The eval model never refreshes (no serving
        context rides the eval path), so the holdout cannot leak
        through the cursor."""
        p: NextItemDataSourceParams = self.params
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
        sessionizer = Sessionizer(gap_s=p.gap_s)
        store = TransitionStore(half_life_s=p.half_life_s)
        trans = []
        for e in train:
            te = e.event_time.timestamp()
            t = sessionizer.feed(e.entity_id, e.target_entity_id, te)
            if t is not None:
                trans.append((t[0], t[1], te))
        store.add_many(trans)
        td = NextItemTrainingData(
            store=store, sessionizer=sessionizer, cursor=0,
            app_id=app_id, n_events=len(train),
        )
        qa = []
        held_sessions = sessionize(
            ((e.entity_id, e.target_entity_id,
              e.event_time.timestamp()) for e in held),
            gap_s=p.gap_s,
        )
        for sess in held_sessions:
            if len(sess) < 2:
                continue
            qa.append((
                Query(item=sess[0], num=p.eval_num),
                ActualItems(items=tuple(sess[1:])),
            ))
        if not qa:
            return []
        return [(td, {"holdout": p.eval_holdout,
                      "sessions": len(qa)}, qa)]


class NextItemModel:
    """The transition store + live session state + the watermark cursor
    that keeps them fresh.  Refresh bookkeeping happens under
    ``_lock``; the store has its own internal lock and the two never
    nest."""

    def __init__(self, store: TransitionStore, sessionizer: Sessionizer,
                 cursor, app_id: int, channel_id: int,
                 event_names: tuple[str, ...], refresh_s: float,
                 scan_page: int = 50000):
        self._lock = threading.Lock()
        self.store = store
        self.sessionizer = sessionizer
        self.cursor = cursor
        self.app_id = int(app_id)
        self.channel_id = int(channel_id)
        self.event_names = tuple(event_names)
        self.refresh_s = float(refresh_s)
        self.scan_page = int(scan_page)
        self._last_refresh_mono = time.monotonic()
        self.stale = False
        self.refreshes = 0
        self.events_folded = 0

    @classmethod
    def from_training(cls, data: NextItemTrainingData,
                      dp: NextItemDataSourceParams) -> "NextItemModel":
        return cls(
            data.store, data.sessionizer, data.cursor, data.app_id,
            dp.channel_id, dp.event_names, dp.refresh_s, dp.scan_page,
        )

    def refresh(self, es, force: bool = False) -> int:
        """Fold events past the cursor through the live sessionizer
        into the store; returns the number folded.  Throttled to
        ``refresh_s`` unless forced; store failures (incl. the
        ``storage.read`` chaos point) leave the stale matrix serving
        and mark :attr:`stale`."""
        if self.refresh_s < 0 and not force:
            return 0
        with self._lock:
            if not force and (
                time.monotonic() - self._last_refresh_mono
                < self.refresh_s
            ):
                return 0
            self._last_refresh_mono = time.monotonic()
            cursor = self.cursor
        try:
            faults.check("storage.read")
            new_cursor, n, _ = scan_transitions(
                es, self.app_id, self.channel_id, cursor,
                self.event_names, self.sessionizer, self.store,
                page=self.scan_page,
            )
        except Exception as e:
            RESILIENCE_TOTAL.labels(kind="nextitem.stale_serve").inc()
            with self._lock:
                self.stale = True
            logger.warning(
                "nextitem refresh failed (%s: %s); serving the stale "
                "matrix", type(e).__name__, e,
            )
            return 0
        with self._lock:
            self.cursor = new_cursor
            self.stale = False
            self.refreshes += 1
            self.events_folded += n
        if n:
            app = str(self.app_id)
            SESSION_EVENTS_TOTAL.labels(app=app).inc(n)
            SESSION_TRANSITIONS.labels(app=app).set(
                float(self.store.n_pairs)
            )
        return n

    def anchor_for(self, query: Query) -> Optional[str]:
        if query.item is not None:
            return query.item
        if query.user is not None:
            return self.sessionizer.last_item(query.user)
        return None


@dataclass(frozen=True)
class NextItemAlgorithmParams(Params):
    pass


class NextItemAlgorithm(Algorithm):
    """Markov passthrough: train adopts the DataSource's sessionized
    scan as the model; predict is a host-side successor-row rank after
    a cursor refresh."""

    params_class = NextItemAlgorithmParams
    placement = ModelPlacement.HOST

    def train(self, ctx: WorkflowContext,
              data: NextItemTrainingData) -> NextItemModel:
        dp = self._datasource_params(ctx)
        return NextItemModel.from_training(data, dp)

    def _datasource_params(self, ctx=None) -> NextItemDataSourceParams:
        # serving knobs (cursor refresh cadence, event names) live on
        # the DataSource params; the engine wiring attaches them via a
        # private attr — defaults for direct library callers
        return getattr(self, "_ds_params", None) or \
            NextItemDataSourceParams()

    def _event_store(self):
        ctx = getattr(self, "_ctx", None)
        if ctx is None:
            return None
        return ctx.storage.get_event_store()

    def _maybe_refresh(self, model: NextItemModel,
                       force: bool = False) -> None:
        es = self._event_store()
        if es is not None:
            model.refresh(es, force=force)

    def warmup(self, model: NextItemModel, max_batch: int = 64) -> None:
        # host-side model, nothing to compile; prime one refresh so
        # the first query pays no scan
        self._maybe_refresh(model, force=True)

    def _predict_fresh(self, model: NextItemModel,
                       query: Query) -> PredictedResult:
        anchor = model.anchor_for(query)
        if anchor is None:
            return PredictedResult(item_scores=())
        scores = model.store.top_successors(
            anchor, query.num, blacklist=query.blacklist or (),
        )
        return PredictedResult(item_scores=tuple(
            ItemScore(item=str(i), score=s) for i, s in scores
        ))

    def predict(self, model: NextItemModel,
                query: Query) -> PredictedResult:
        self._maybe_refresh(model)
        return self._predict_fresh(model, query)

    def batch_predict(self, model: NextItemModel,
                      queries: Sequence[Query]) -> list[PredictedResult]:
        # the whole coalesced flight pays ONE throttled cursor refresh
        # — this override is what turns the serving auto-batcher on
        # for nextitem
        self._maybe_refresh(model)
        return [self._predict_fresh(model, q) for q in queries]

    # -- persistence (the model holds locks; JSON round-trip) --------------
    def save_model(self, ctx, model_id, model: NextItemModel, base_dir):
        import json as _json

        base_dir.mkdir(parents=True, exist_ok=True)
        with model._lock:
            doc = {
                "store": model.store.to_doc(),
                "sessionizer": model.sessionizer.to_doc(),
                "cursor": model.cursor,
                "appId": model.app_id,
                "channelId": model.channel_id,
                "eventNames": list(model.event_names),
                "refreshSec": model.refresh_s,
                "scanPage": model.scan_page,
            }
        path = base_dir / f"{model_id}-nextitem.json"
        path.write_text(_json.dumps(doc))
        return {"json": path.name}

    def load_model(self, ctx, model_id, manifest, base_dir):
        import json as _json

        doc = _json.loads((base_dir / manifest["json"]).read_text())
        return NextItemModel(
            TransitionStore.from_doc(doc["store"]),
            Sessionizer.from_doc(doc["sessionizer"]),
            doc["cursor"], doc["appId"], doc["channelId"],
            tuple(doc["eventNames"]), doc["refreshSec"],
            doc.get("scanPage", 50000),
        )


class _NextItemEngine(Engine):
    """Engine whose algorithm needs the DataSource params at serve
    time (the cursor-refresh knobs live there)."""

    def _algorithms(self, ep):
        algos = super()._algorithms(ep)
        ds_params = ep.data_source[1]
        if isinstance(ds_params, NextItemDataSourceParams):
            for a in algos:
                a._ds_params = ds_params
        return algos


def nextitem_engine() -> Engine:
    return _NextItemEngine(
        NextItemDataSource,
        IdentityPreparator,
        {"nextitem": NextItemAlgorithm, "": NextItemAlgorithm},
        FirstServing,
    )


def nextitem_evaluation(app_name: str = "MyApp", k: int = 10,
                        holdout: float = 0.2):
    """MAP@k evaluation binding: `eval --engine nextitem`
    scores held-out sessions' follow-on items from each session's
    first item on a time split.  ``refreshSec=-1`` pins the eval model
    to its training window."""
    from ..controller import Evaluation
    from ..controller.metrics import MAPatK

    engine = nextitem_engine()
    ep = engine.params_from_variant({
        "datasource": {"params": {
            "appName": app_name, "refreshSec": -1.0,
            "evalHoldout": holdout, "evalNum": k,
        }},
        "algorithms": [{"name": "nextitem", "params": {}}],
    })
    return Evaluation(engine, MAPatK(k), engine_params_list=[ep])


# -- pio-forge registration -------------------------------------------------


def _conformance_events():
    import datetime as _dt

    from ..storage import Event

    # five users each walk a -> b -> c inside one session (strictly
    # increasing timestamps), so b is deterministically a's top
    # successor; one decoy user views only d (single-event session —
    # contributes no transitions)
    base = _dt.datetime.now(_dt.timezone.utc) - _dt.timedelta(minutes=30)
    events = []
    for n in range(5):
        for j, item in enumerate(("a", "b", "c")):
            events.append(Event(
                event="view", entity_type="user", entity_id=f"u{n}",
                target_entity_type="item", target_entity_id=item,
                event_time=base + _dt.timedelta(seconds=60 * n + j),
            ))
    events.append(Event(
        event="view", entity_type="user", entity_id="lurker",
        target_entity_type="item", target_entity_id="d",
        event_time=base,
    ))
    return events


from ..engines import ConformanceFixture, engine_spec  # noqa: E402

nextitem_engine = engine_spec(
    "nextitem",
    description=(
        "Markov next-item: gap-sessionized transition counts with "
        "half-life decay, served straight from event-store cursor "
        "scans (CSR successor rows, no factor model, no device)"
    ),
    default_params={
        "datasource": {
            "params": {"appName": "MyApp",
                       "eventNames": ["view", "rate", "buy"],
                       "sessionGapSec": 1800.0,
                       "halfLifeSec": 604800.0, "refreshSec": 2.0}
        },
        "algorithms": [{"name": "nextitem", "params": {}}],
    },
    query_example={"user": "u1", "item": "a", "num": 5},
    evaluation=nextitem_evaluation,
    conformance=ConformanceFixture(
        app_name="forge-conf",
        seed_events=_conformance_events,
        queries=({"user": "u0", "item": "a", "num": 2},),
        check=lambda r: bool(r.get("itemScores"))
        and r["itemScores"][0]["item"] == "b",
        variant={
            "datasource": {"params": {"appName": "forge-conf",
                                      "eventNames": ["view"],
                                      "refreshSec": 0.0}},
            "algorithms": [{"name": "nextitem", "params": {}}],
        },
    ),
)(nextitem_engine)
