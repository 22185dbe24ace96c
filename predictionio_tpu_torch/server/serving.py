"""Engine deployment server: answers ``/queries.json`` with predictions.

Port of ``predictionio_tpu/server/serving.py``, a re-expression of the
reference's `workflow/CreateServer.scala` (`ServerActor` routes
`:433-612`, `MasterActor` lifecycle `:255-377`).  Routes:

* ``GET  /``             — status JSON: engine info, request count, latency
  (``avgServingSec``/``lastServingSec`` parity, `CreateServer.scala:552-559`),
  or the HTML status page for ``Accept: text/html``
* ``POST /queries.json`` — score a query (the hot path); concurrent
  queries are coalesced into one batched device call by the
  micro-batcher (:mod:`predictionio_tpu_torch.server.microbatch`) when
  every algorithm has a real ``batch_predict`` (``microbatch="auto"``)
* ``GET  /reload``       — hot-swap to the latest COMPLETED engine instance
* ``POST /foldin/apply`` — apply the fold-in delta links published for
  the serving instance now (the replica router's rolling push)
* ``POST /stop``         — graceful shutdown
* ``GET  /metrics`` and ``/debug/*`` — the observability mounts
  (``server/http_base.py``)
* with a tenant registry (``deploy --multi``): ``POST /tenants/weights``
  and ``POST /admin/tenants`` (the weights and the tenants, live),
  ``GET /debug/tenants`` and ``GET /debug/experiments``

Two edges answer the port (``ServerConfig.edge``): ``"eventloop"`` (the
default) is one selector thread (:mod:`.eventloop`) that parses every
connection and hands queries to the batcher's dispatcher with
``submit_nowait``, blocking routes to a small aux pool; ``"threads"`` is
the stdlib threading server, one thread per connection, each query a
blocking ``submit``.  With ``shared_batcher`` (the default) the server's
batcher is a view on one :class:`~.microbatch.SharedBatcher`.

Query/result JSON mapping: the engine's first algorithm may declare
``query_class`` (with ``from_json``) and results may expose ``to_json``.
The server's device is its context's, which defaults to the card.

With ``feedback`` and an ``event_server_url``, every answered query
posts a ``pio_pr``/``predict`` event (the query and the prediction) to
the event server and carries its ``prId`` in the reply; with a
``log_url``, invalid and failed queries post ``log_prefix`` + a JSON
record there (`CreateServer.scala:413-424,480-550`).  Both leave through
bounded delivery queues (:class:`~..resilience.DeliveryQueue`) with
retries behind a circuit breaker, so a dead collector never stalls
serving; the feedback hop carries the query's ``X-PIO-Trace``.

Observability is the reference's: the query latency histogram (with
trace-id exemplars) behind ``/status``'s percentiles, per-outcome
counters, ``serve.query`` spans under the request's ``X-PIO-Trace`` id
(echoed on the reply), the pulse timeline of each query, the flight
recorder, ``slo_ms`` burn rates and the device-memory sampler; and the
fault points ``reload.load_model``, ``device.dispatch``,
``http.feedback`` and ``http.remote_log``.

Fold-in (``live/``): a load, every ``foldin_poll_s`` seconds (``deploy
--foldin-poll``) and ``POST /foldin/apply`` apply the instance's delta
links past the last one applied, in place under the state lock (factor
rows and the cached device tables patched row-wise; no reload, no
warm-up), behind a circuit breaker that pauses the poll while applies
keep failing.  Status JSON then carries ``modelFreshnessSec``,
``foldinWatermarkLag``, ``foldinDeltasApplied`` and
``foldinBreakerState``, and a query's span ``foldinSeq``.

Tenancy (``tenants=``, a :class:`~..tenancy.TenantRegistry`): the
server's own components are the anchor tenant's; a query naming an
``app``/``appId``/``accessKey`` (and a ``variant``, or one assigned from
its ``user``) is routed to its tenant's components, loaded lazily under
the memory budget, before its decode.  The tenant's quota answers 429
(``QuotaExceeded``) and its breaker or a failed load 503
(``TenantUnavailable``); the fault point ``tenant.dispatch`` is scoped
to a tenant.  Every tenant's batcher is a view on the one shared
batcher, weighted by its variant's share; the reply carries the
variant, the feedback event its app and variant, and an online-eval
thread folds the variant-tagged conversions back out of the store every
``eval_interval_s`` and ticks the autopilot.  Without a registry those
routes answer 404.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import sys
import threading
import time
import urllib.parse
import uuid
from dataclasses import asdict, is_dataclass
from typing import Any, Callable, Optional

from ..controller.base import Algorithm, WorkflowContext
from ..controller.engine import Engine, EngineParams
from ..engines import engine_label_of
from ..obs import (
    ENGINE_QUERIES_TOTAL,
    FOLDIN_APPLIES_TOTAL,
    FOLDIN_PHASE_SECONDS,
    FOLDIN_WATERMARK_LAG,
    MODEL_FRESHNESS_SECONDS,
    QUERIES_TOTAL,
    QUERY_LATENCY,
    RELOADS_TOTAL,
    TRACE_HEADER,
    Histogram,
    current_trace_id,
    fleet,
    get_flight_recorder,
    get_tracer,
    new_trace_id,
    scope,
    timeline,
    trace_scope,
    xray,
)
from ..obs.timeline import SERVE_INFLIGHT, annotate
from ..resilience import DeliveryQueue, faults
from ..resilience.policy import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    deadline_scope,
)
from ..tenancy.errors import QuotaExceeded, TenantUnavailable
from ..workflow.train import prepare_deploy_components
from .eventloop import EventLoopHTTPServer, callback_scope
from .http_base import (
    DEFAULT_MAX_CONNECTIONS,
    HTTPServerBase,
    JsonRequestHandler,
    observability_response,
)
from .microbatch import (
    AdmissionRejected,
    MicroBatcher,
    SharedBatcher,
    SharedBatcherView,
)

logger = logging.getLogger(__name__)

__all__ = ["EngineServer", "ServerConfig"]

_m_inflight = SERVE_INFLIGHT.child()

# query outcomes, the label values of pio_queries_total
_STATUSES = ("ok", "bad_request", "timeout", "error", "rejected")
# pio_engine_queries_total adds the tenant sheds, which
# pio_queries_total books as "rejected"
_ENGINE_STATUSES = _STATUSES + ("quota", "shed")
_TENANT_SHEDS = ("quota", "shed")

# the feedback and remote-log delivery queues' retries: attempts an
# entry gets while the breaker lets it through, the backoff's base and
# cap, and one POST's timeout (the reference's defaults)
_DELIVERY_ATTEMPTS = 50
_DELIVERY_BASE_S = 0.1
_DELIVERY_CAP_S = 5.0
_DELIVERY_TIMEOUT_S = 2.0


class ServerConfig:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 microbatch: str = "auto", microbatch_max: int = 64,
                 shared_batcher: bool = True,
                 query_timeout_s: Optional[float] = None,
                 edge: str = "eventloop",
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 feedback: bool = False,
                 event_server_url: Optional[str] = None,
                 access_key: Optional[str] = None,
                 log_url: Optional[str] = None, log_prefix: str = "",
                 feedback_capacity: int = 1024,
                 breaker_failures: int = 5,
                 breaker_reset_s: float = 10.0,
                 foldin_poll_s: Optional[float] = None,
                 slo_ms: Optional[float] = None):
        self.host = host
        self.port = port
        # which HTTP front end answers the port: "eventloop" = one
        # selector thread parses and routes every connection, device work
        # rides the batcher's dispatcher, blocking routes a small aux
        # pool; "threads" = the stdlib threading server, one thread per
        # connection
        if edge not in ("eventloop", "threads"):
            raise ValueError(f"edge must be eventloop|threads, got {edge!r}")
        self.edge = edge
        # concurrent-connection cap (both edges): connection attempts
        # past it are answered a structured 503 and closed
        self.max_connections = max_connections
        # feedback-loop event injection: answered queries go back to the
        # event server at event_server_url as pio_pr events
        self.feedback = feedback
        self.event_server_url = event_server_url
        self.access_key = access_key
        # remote error-log shipping (CreateServer.scala:413-424): serving
        # failures POST `log_prefix + json` to log_url, fire-and-forget
        self.log_url = log_url
        self.log_prefix = log_prefix
        # the feedback/remote-log delivery queues' capacity, and their
        # breakers' failure threshold and reset seconds
        self.feedback_capacity = feedback_capacity
        self.breaker_failures = breaker_failures
        self.breaker_reset_s = breaker_reset_s
        # concurrent-query coalescing (server/microbatch.py): "auto"
        # batches when every algorithm provides a real batch_predict,
        # "on" forces it, "off" keeps per-request device calls
        if microbatch not in ("auto", "on", "off"):
            raise ValueError(
                f"microbatch must be auto|on|off, got {microbatch!r}"
            )
        self.microbatch = microbatch
        self.microbatch_max = microbatch_max
        # one SharedBatcher per server, this server's batcher a view on
        # it (off = a private MicroBatcher)
        self.shared_batcher = shared_batcher
        # per-request time budget (None = unbounded); expiry answers a
        # structured 503 instead of queueing device work for a client
        # that already gave up
        self.query_timeout_s = query_timeout_s
        # pio-live: poll the model dir for fold-in delta links every N
        # seconds and patch them into the serving model in place (no
        # reload).  None = off; links already on disk at (re)load time
        # are still caught up once.
        self.foldin_poll_s = foldin_poll_s
        # end-to-end latency SLO (ms): arms the pio_slo_burn_rate{window}
        # gauges on this server's latency histogram
        self.slo_ms = slo_ms


class _QueryCtx:
    """Per-query snapshot shared by the blocking and event-loop paths:
    the decoded query, its deadline, the components captured under the
    state lock (or its tenant's), and the tenant lease it holds."""

    __slots__ = ("query_json", "query", "deadline", "algorithms", "models",
                 "serving", "batcher", "lease")

    def __init__(self, query_json, query, deadline, algorithms, models,
                 serving, batcher, lease=None):
        self.query_json = query_json
        self.query = query
        self.deadline = deadline
        self.algorithms = algorithms
        self.models = models
        self.serving = serving
        self.batcher = batcher
        self.lease = lease


def _default_query_decoder(engine: Engine, engine_params: EngineParams):
    """The first algorithm's ``query_class`` (or, by the template
    convention, its module's ``Query``) decodes with ``from_json``;
    without one the query is the JSON object itself.  The reference's
    decoding of a plain dataclass ``Query`` waits for a ported engine
    that needs it."""
    name, _ = engine_params.algorithms[0]
    cls = engine._lookup(engine.algorithm_class_map, name, "algorithm")
    qcls = getattr(cls, "query_class", None) or getattr(
        sys.modules.get(cls.__module__), "Query", None)
    return getattr(qcls, "from_json", None) or (lambda d: d)


def _result_to_json(r: Any) -> Any:
    if hasattr(r, "to_json"):
        return r.to_json()
    if is_dataclass(r) and not isinstance(r, type):
        return asdict(r)
    if isinstance(r, (list, tuple)):
        return [_result_to_json(v) for v in r]
    if isinstance(r, dict):
        return {k: _result_to_json(v) for k, v in r.items()}
    return r


def _parse_query(body: bytes, query_str: str) -> tuple:
    """``(query JSON, per-request timeout or None, None)`` of a ``POST
    /queries.json`` (``?timeout=0.5`` sets the budget), or ``(None,
    None, the 400 message)``; both edges."""
    try:
        query_json = json.loads(body.decode() or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        return None, None, f"invalid JSON: {e}"
    tv = urllib.parse.parse_qs(query_str).get("timeout")
    if not tv:
        return query_json, None, None
    try:
        return query_json, float(tv[0]), None
    except ValueError:
        return None, None, f"bad timeout: {tv[0]!r}"


def _outcome(e: BaseException) -> str:
    """A failed query's outcome: the label of its tenant's and its
    engine's counters (``pio_queries_total`` books a tenant shed as
    ``rejected``)."""
    if isinstance(e, QuotaExceeded):
        return "quota"
    if isinstance(e, TenantUnavailable):
        return "shed"
    if isinstance(e, AdmissionRejected):
        return "rejected"
    if isinstance(e, DeadlineExceeded):
        return "timeout"
    if isinstance(e, (KeyError, ValueError, TypeError)):
        return "bad_request"
    return "error"


# the structured replies of the sheds: (status code, error name)
_SHED_REPLIES = {
    # the client is over its tenant's rate, not the server over
    # capacity: 429, not 503
    "quota": (429, "QuotaExceeded"),
    "shed": (503, "TenantUnavailable"),
    "rejected": (503, "AdmissionRejected"),
    "timeout": (503, "DeadlineExceeded"),
}


def _error_reply(e: BaseException) -> tuple:
    """``(outcome, code, payload, extra headers)`` answering a failed
    query, on both edges."""
    status = _outcome(e)
    if status in _SHED_REPLIES:
        code, name = _SHED_REPLIES[status]
        return (status, code, {"message": str(e), "error": name},
                [("Retry-After", "1")])
    if status == "bad_request":
        return status, 400, {"message": f"bad query: {e}"}, []
    logger.error("query failed", exc_info=e)
    return status, 500, {"message": str(e)}, []


def _warm_components(algorithms, models, warm_max: int) -> None:
    """Run each algorithm's warmup ladder up to the batcher's maximum so
    the first query pays no one-time device set-up.  A warmup failure
    only costs the first query; it never fails the load."""
    for algo, model in zip(algorithms, models):
        t0 = time.perf_counter()
        try:
            algo.warmup(model, max_batch=warm_max)
        except Exception:
            logger.exception(
                "warmup failed for %s (the first query pays its set-up)",
                type(algo).__name__,
            )
        else:
            logger.info("%s warmed up in %.2fs", type(algo).__name__,
                        time.perf_counter() - t0)


def _experiments_response(tenants) -> tuple:
    """``GET /debug/experiments``: the autopilot's live document, a
    disabled stub when tenancy runs without an autopilot, 404 when there
    is no tenancy (unless this process installed an autopilot
    elsewhere).  Returns ``(code, payload)``."""
    if tenants is None:
        from ..tenancy.autopilot import autopilot_payload

        doc = autopilot_payload()
        if doc is not None:
            return 200, doc
        return 404, {"message": "tenancy is not enabled (deploy --multi)"}
    pilot = tenants.autopilot
    if pilot is not None:
        return 200, pilot.payload()
    return 200, {
        "enabled": False,
        "weights": {app: tenants.experiment(app).weights()
                    for app in tenants.apps()},
        "onlineEval": tenants.online.snapshot(),
    }


class EngineServer(HTTPServerBase):
    """One deployed engine instance behind an HTTP server; with
    ``tenants`` (a :class:`~..tenancy.TenantRegistry`) the host of every
    tenant of the registry, the instance being the anchor tenant's."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        instance_id: str,
        ctx: Optional[WorkflowContext] = None,
        config: Optional[ServerConfig] = None,
        query_decoder: Optional[Callable[[dict], Any]] = None,
        engine_id: str = "default",
        engine_version: str = "1",
        engine_variant: str = "engine.json",
        tenants=None,
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.ctx = ctx or WorkflowContext(mode="Serving")
        self.config = config or ServerConfig()
        self.instance_id = instance_id
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        # the registry gets this server's component loader unless the
        # caller injected its own (prebuilt models in tests)
        self.tenants = tenants
        if tenants is not None and tenants.loader is None:
            tenants.loader = self._tenant_loader
        self.query_decoder = query_decoder or _default_query_decoder(
            engine, engine_params
        )
        self._lock = threading.RLock()
        self.last_reload_error: Optional[str] = None
        # bounded background delivery (resilience/delivery.py); built
        # even when feedback and log_url are off (the drain thread only
        # starts on the first submit)
        self._feedback_queue = self._delivery_queue("feedback",
                                                    "http.feedback")
        self._log_queue = self._delivery_queue("remote-log",
                                               "http.remote_log")
        # aux pool for the event-loop edge's blocking routes (status,
        # reload, unbatched predicts); built at its first bind
        self._aux_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # the server's SharedBatcher, built by the first _make_batcher
        # that wants one
        self._shared_core: Optional[SharedBatcher] = None
        self._shared_lock = threading.Lock()
        self._teardown_lock = threading.Lock()
        # the delta poll's breaker, built before the first _load (which
        # catches up on a chain already on disk): repeated apply
        # failures open it, the poll pauses and the stale model serves
        self._foldin_breaker = CircuitBreaker(
            failure_threshold=self.config.breaker_failures,
            reset_timeout_s=self.config.breaker_reset_s,
        )
        self._foldin_stop = threading.Event()
        self._load(instance_id)
        if self.config.foldin_poll_s:
            threading.Thread(target=self._foldin_poll_loop, daemon=True,
                             name="foldin-poll").start()
        # the online eval folds the variant-tagged conversions back out
        # of the event store on the registry's cadence
        self._eval_stop = threading.Event()
        if self.tenants is not None:
            threading.Thread(target=self._online_eval_loop, daemon=True,
                             name="hive-eval").start()
        # serving stats (CreateServer.scala:396-398).  Latency is
        # histogram-backed: this instance's private histogram drives the
        # /status percentiles and average, and the same observations feed
        # the process-wide pio_query_latency_seconds that /metrics shows
        self.request_count = 0
        self.last_serving_sec = 0.0
        self.start_time = time.time()  # wall clock: a TIMESTAMP, not a span
        self._latency = Histogram()
        self._m_latency = QUERY_LATENCY.child()
        # per-outcome counters resolved once (labels() is too hot for the
        # request path); shared by both edges
        self._m_queries = {
            s: QUERIES_TOTAL.labels(status=s) for s in _STATUSES
        }
        self.engine_name = engine_label_of(engine, fallback=engine_id)
        self._m_engine_queries = {
            s: ENGINE_QUERIES_TOTAL.labels(engine=self.engine_name,
                                           status=s)
            for s in _ENGINE_STATUSES
        }
        self._burn = None
        if self.config.slo_ms:
            self._burn = fleet.install_burn_rate(
                self._m_latency, self.config.slo_ms / 1e3
            )
        # the device sampler keeps pio_device_memory_bytes fresh, and the
        # always-on stack sampler rides every serving process
        xray.install()
        xray.start_sampler()
        scope.ensure_started()

    def _delivery_queue(self, name: str, point: str) -> DeliveryQueue:
        return DeliveryQueue(
            name,
            capacity=self.config.feedback_capacity,
            retry=RetryPolicy(max_attempts=_DELIVERY_ATTEMPTS,
                              base_s=_DELIVERY_BASE_S,
                              cap_s=_DELIVERY_CAP_S),
            breaker=CircuitBreaker(
                failure_threshold=self.config.breaker_failures,
                reset_timeout_s=self.config.breaker_reset_s,
            ),
            timeout_s=_DELIVERY_TIMEOUT_S,
            fault_point=point,
        )

    # -- lifecycle --------------------------------------------------------
    def _load(self, instance_id: str) -> None:
        """Load an instance's components and swap them in atomically; a
        failed (re)load leaves the previous components serving (the
        ``reload.load_model`` injection point proves it)."""
        faults.check("reload.load_model")
        # serve with the params the instance was trained with; the current
        # engine.json may have drifted (engineInstanceToEngineParams parity)
        with self._lock:
            variant_params = self.engine_params
        engine_params = variant_params
        rec = self.ctx.storage.get_metadata().engine_instance_get(instance_id)
        if rec is not None and rec.algorithms_params:
            try:
                engine_params = self.engine.params_from_instance(rec)
            except Exception:
                logger.exception(
                    "could not reconstruct params from instance %s; "
                    "using variant params", instance_id,
                )
                engine_params = variant_params
        algorithms, models, serving = prepare_deploy_components(
            self.engine, engine_params, instance_id, ctx=self.ctx
        )
        batcher = self._make_batcher(algorithms, models)
        # 0 = no batched path at all (an empty warmup ladder)
        warm_max = self.config.microbatch_max if batcher is not None else 0
        _warm_components(algorithms, models, warm_max)
        with self._lock:
            old_batcher = getattr(self, "batcher", None)
            self.engine_params = engine_params
            self.models = models
            self.algorithms = algorithms
            self.serving = serving
            self.instance_id = instance_id
            self.batcher = batcher
            # when the serving model last advanced (a load or an applied
            # delta): the freshness a flight record carries.  The
            # fold-in bookkeeping restarts with every load: the delta
            # chain is per instance
            self.model_advanced_mono = time.monotonic()
            self.foldin_applied_seq = {}
            self.foldin_watermark = None
            self.foldin_deltas_applied = 0
            self.last_foldin_error = None
        # the old batcher's dispatcher (continuous path) drains and
        # exits; in-flight queries still holding it complete
        if old_batcher is not None and old_batcher is not batcher:
            old_batcher.close()
        # catch up on the delta links already published for this
        # instance: a (re)load must not serve staler than the chain
        self._apply_available_deltas()
        # the loaded components are the anchor tenant's too (one copy
        # serves the tenant-less path and the anchor's queries; a reload
        # advances both)
        if getattr(self, "tenants", None) is not None:
            self._adopt_anchor_runtime()

    # -- tenants ------------------------------------------------------------
    def _tenant_breaker(self) -> CircuitBreaker:
        return CircuitBreaker(
            failure_threshold=self.config.breaker_failures,
            reset_timeout_s=self.config.breaker_reset_s,
        )

    @staticmethod
    def _tenant_quota(spec):
        from ..tenancy.quota import TokenBucket

        if spec.quota_qps is None:
            return None
        return TokenBucket(spec.quota_qps, spec.quota_burst)

    def _adopt_anchor_runtime(self) -> None:
        from ..tenancy.registry import TenantRuntime

        spec = self.tenants.spec(self.tenants.anchor_key)
        with self._lock:
            rt = TenantRuntime(
                spec, self.engine, self.engine_params, self.instance_id,
                self.algorithms, self.models, self.serving, self.batcher,
                self.query_decoder, self.ctx,
                breaker=self._tenant_breaker(),
                quota=self._tenant_quota(spec),
            )
        self.tenants.adopt_anchor(rt)

    def _resolve_tenant_components(self, spec):
        """``(engine, engine_params, instance_id, ctx)`` of a spec:
        prebuilt objects win, then a registered engine name, else the
        engine.json is loaded; the latest COMPLETED instance resolves as
        ``deploy`` resolves it."""
        ctx = spec.ctx or self.ctx
        if spec.engine is not None:
            if spec.instance_id is None:
                raise ValueError(
                    f"tenant {spec.key_str}: a prebuilt engine needs an "
                    "instance_id"
                )
            return spec.engine, spec.engine_params, spec.instance_id, ctx
        if spec.engine_name:
            from .. import engines

            engine, ep, variant = engines.resolve(spec.engine_name)
            variant_key = engines.get_engine_spec(
                spec.engine_name).instance_variant_key()
        else:
            from ..cli.main import load_engine_from_variant

            engine, ep, variant = load_engine_from_variant(spec.engine_json)
            variant_key = str(spec.engine_json)
        iid = spec.instance_id
        if iid is None:
            latest = ctx.storage.get_metadata(
            ).engine_instance_get_latest_completed(
                variant.get("id", "default"), "1", variant_key)
            if latest is None:
                raise LookupError(
                    f"tenant {spec.key_str}: no completed engine "
                    f"instance for {variant_key}; train it first"
                )
            iid = latest.id
        return engine, ep, iid, ctx

    def _tenant_loader(self, spec):
        """One tenant's serving runtime, built as ``_load`` builds the
        anchor's (components, batcher view, warm-up, decoder, and the
        links of its delta chain applied) plus its own breaker and
        quota.  The runtime counts its bytes after the warm-up, so the
        device tables the warm-up makes are in them."""
        from ..tenancy.registry import TenantRuntime

        engine, ep, iid, ctx = self._resolve_tenant_components(spec)
        algorithms, models, serving = prepare_deploy_components(
            engine, ep, iid, ctx=ctx)
        batcher = self._make_batcher(algorithms, models, tenant=spec.key)
        warm_max = self.config.microbatch_max if batcher is not None else 0
        _warm_components(algorithms, models, warm_max)
        rt = TenantRuntime(
            spec, engine, ep, iid, algorithms, models, serving, batcher,
            _default_query_decoder(engine, ep), ctx,
            breaker=self._tenant_breaker(),
            quota=self._tenant_quota(spec),
        )
        self.tenants.catch_up(rt)
        return rt

    def _online_eval_loop(self) -> None:
        """Every ``eval_interval_s`` (at least 0.5 s): fold the new
        conversions into the online-eval table, then one autopilot tick
        (a no-op without an autopilot; it never raises)."""
        scope.register_thread_role("hive_eval")
        interval = max(float(self.tenants.eval_interval_s), 0.5)
        while not self._eval_stop.wait(interval):
            try:
                self.tenants.refresh_online_eval(
                    self.ctx.storage.get_event_store())
            except Exception:
                logger.exception("online-eval refresh failed")
            try:
                self.tenants.autopilot_tick()
            except Exception:
                logger.exception("autopilot tick failed")

    def _make_batcher(self, algorithms, models, tenant=None):
        """The query micro-batcher for this (algorithms, models) snapshot
        (a view on the server's SharedBatcher, or a private
        MicroBatcher), or None when batching cannot help: ``"auto"``
        batches only when every algorithm overrides ``batch_predict``
        (the base class just maps ``predict``).  A tenant's view claims
        by its variant's share of its app's weights, read at claim time
        (a ``POST /tenants/weights`` reshapes the next claim)."""
        mode = self.config.microbatch
        if mode == "off":
            return None
        if mode == "auto" and not all(
            type(a).batch_predict is not Algorithm.batch_predict
            for a in algorithms
        ):
            return None

        def batch_fn(queries):
            if len(queries) == 1:
                # a solo batch rides the scalar predict path
                q = queries[0]
                return [[
                    algo.predict(model, q)
                    for algo, model in zip(algorithms, models)
                ]]
            per_algo = [
                algo.batch_predict(model, queries)
                for algo, model in zip(algorithms, models)
            ]
            return [
                [pa[i] for pa in per_algo] for i in range(len(queries))
            ]

        if not self.config.shared_batcher:
            return MicroBatcher(
                batch_fn, max_batch=self.config.microbatch_max,
                pad_batches=True,
            )
        # the view carries this snapshot's batch_fn, so in-flight queries
        # survive a reload on the model they snapshotted
        with self._shared_lock:
            if self._shared_core is None:
                self._shared_core = SharedBatcher(
                    max_batch=self.config.microbatch_max, pad_batches=True,
                )
            core = self._shared_core
        tenants = getattr(self, "tenants", None)
        if tenant is None:
            tenant = (tenants.anchor_key if tenants is not None
                      else "__anchor__")
        weight_fn = None
        if tenants is not None:
            def weight_fn(key=tenant):
                return tenants.deficit_weight(key)

        return SharedBatcherView(core, tenant, batch_fn, weight_fn=weight_fn)

    def reload(self) -> str:
        """Swap in the latest COMPLETED instance (GET /reload).  A failed
        load is recorded (``lastReloadError``) and re-raised; the previous
        components keep serving."""
        md = self.ctx.storage.get_metadata()
        latest = md.engine_instance_get_latest_completed(
            self.engine_id, self.engine_version, self.engine_variant
        )
        if latest is None:
            raise LookupError("no completed engine instance found")
        with get_tracer().span("serve.reload",
                               attrs={"instance": latest.id}):
            try:
                self._load(latest.id)
            except Exception as e:
                with self._lock:
                    self.last_reload_error = f"{type(e).__name__}: {e}"
                RELOADS_TOTAL.labels(result="error").inc()
                raise
        with self._lock:
            self.last_reload_error = None
        RELOADS_TOTAL.labels(result="ok").inc()
        return latest.id

    # -- pio-live delta apply ---------------------------------------------
    def _apply_available_deltas(self) -> int:
        """Apply the fold-in delta links newer than what this server
        holds, IN PLACE under the state lock: factor rows and the cached
        device tables are patched row-wise, queries in flight keep the
        tables they snapshotted, the next query sees the folded-in rows.
        No reload, no warm-up, no batcher rebuild.

        A torn or gapped chain truncates cleanly
        (``load_model_delta_chain``): the good prefix applies, the rest
        waits.  Returns the number of links applied."""
        from ..live.apply import apply_model_delta, model_supports_deltas
        from ..workflow.model_io import load_model_delta_chain, model_key

        with self._lock:
            iid = self.instance_id
            models = self.models
            ep = self.engine_params
            applied_seq = dict(self.foldin_applied_seq)
        base_dir = self.ctx.storage.model_data_dir() / iid
        names = [n for n, _ in ep.algorithms]
        n_applied = 0
        for ax, (name, model) in enumerate(zip(names, models)):
            if not model_supports_deltas(model):
                continue
            key = model_key(iid, ax, name)
            chain, err = load_model_delta_chain(
                base_dir, key, after_seq=applied_seq.get(key, 0)
            )
            if err:
                with self._lock:
                    self.last_foldin_error = err
                logger.warning("fold-in chain for %s: %s", key, err)
            for d in chain:
                t0 = time.perf_counter()
                with self._lock:
                    if self.instance_id != iid:
                        # a reload swapped instances mid-walk; the new
                        # instance's own catch-up already ran
                        return n_applied
                    if self.foldin_applied_seq.get(key, 0) >= d.seq:
                        # a concurrent walk (the poll, a push) applied it
                        continue
                    apply_model_delta(model, d)
                    self.foldin_applied_seq[key] = d.seq
                    self.foldin_watermark = d.watermark
                    self.foldin_deltas_applied += 1
                    self.model_advanced_mono = time.monotonic()
                    self.last_foldin_error = None
                dt = time.perf_counter() - t0
                FOLDIN_APPLIES_TOTAL.labels(result="ok").inc()
                FOLDIN_PHASE_SECONDS.labels(phase="live.apply").observe(dt)
                get_tracer().record("live.apply", dt,
                                    attrs={"instance": iid, "seq": d.seq})
                n_applied += 1
        return n_applied

    def _foldin_poll_loop(self) -> None:
        """The delta poll (``foldin_poll_s``): breaker-guarded and
        deadline-scoped, so a sick storage volume pauses the poll and
        leaves the stale model serving, never a wedged thread."""
        scope.register_thread_role("foldin_runner")
        interval = float(self.config.foldin_poll_s)
        while not self._foldin_stop.wait(interval):
            if not self._foldin_breaker.allow():
                continue
            try:
                with deadline_scope(Deadline.after(max(interval, 1.0))):
                    self._apply_available_deltas()
                    if self.tenants is not None:
                        # every resident tenant's chain; one tenant's
                        # error is booked on that tenant and never pauses
                        # the others
                        self.tenants.apply_available_deltas()
            except Exception as e:
                logger.exception("fold-in delta apply failed; serving "
                                 "keeps the stale model")
                with self._lock:
                    self.last_foldin_error = f"{type(e).__name__}: {e}"
                FOLDIN_APPLIES_TOTAL.labels(result="error").inc()
                self._foldin_breaker.record_failure()
            else:
                self._foldin_breaker.record_success()
            self._foldin_status()  # refreshes the gauges

    def _foldin_status(self) -> dict:
        """The pio-live status fields, or {} while fold-in is off (no
        poll configured, no delta ever applied and no chain error), so
        the status JSON of a deployment that never folds in is
        unchanged.  Computing them also sets the freshness and lag
        gauges."""
        with self._lock:
            active = (
                self.config.foldin_poll_s is not None
                or self.foldin_deltas_applied > 0
                or self.last_foldin_error is not None
            )
            if not active:
                return {}
            advanced_mono = self.model_advanced_mono
            wm = self.foldin_watermark
            err = self.last_foldin_error
            applied = self.foldin_deltas_applied
        freshness = max(time.monotonic() - advanced_mono, 0.0)
        lag = 0
        if wm:
            try:
                # both cursor kinds (an int rowid, the sharded store's
                # shard vector) are the store's own business
                lag = max(self.ctx.storage.get_event_store().cursor_lag(
                    int(wm.get("appId", -1)), int(wm.get("channelId", 0)),
                    wm.get("rowid", 0),
                ), 0)
            except Exception:
                lag = 0
        out = {
            "modelFreshnessSec": freshness,
            "foldinWatermarkLag": lag,
            "foldinDeltasApplied": applied,
            "foldinBreakerState": self._foldin_breaker.state,
        }
        if err:
            out["lastFoldinError"] = err
        MODEL_FRESHNESS_SECONDS.child().set(freshness)
        FOLDIN_WATERMARK_LAG.child().set(float(lag))
        return out

    def _blocking_foldin_apply(self):
        """``POST /foldin/apply``: apply the pending delta links now
        (the router's rolling push calls this on each replica in turn),
        every resident tenant's too; ``(code, payload, ctype)`` with the
        applied count and the status fields."""
        n = self._apply_available_deltas()
        if self.tenants is not None:
            n += self.tenants.apply_available_deltas()
        out = {"applied": n}
        out.update(self._foldin_status())
        return 200, out, "application/json"

    def _blocking_set_weights(self, raw: bytes):
        """``POST /tenants/weights``: hot-update an app's variant
        weights, ``{"app": ..., "weights": {"variant": w, ...}}`` (the
        router broadcasts it to every replica)."""
        js = "application/json"
        if self.tenants is None:
            return 404, {"message": "tenancy is not enabled"}, js
        try:
            doc = json.loads(raw.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return 400, {"message": f"invalid JSON: {e}"}, js
        app = doc.get("app")
        weights = doc.get("weights")
        if not app or not isinstance(weights, dict) or not weights:
            return 400, {"message": "body needs app + weights{}"}, js
        try:
            snap = self.tenants.set_weights(str(app), weights)
        except KeyError as e:
            return 404, {"message": str(e)}, js
        except (TypeError, ValueError) as e:
            return 400, {"message": str(e)}, js
        return 200, {"updated": snap}, js

    def _blocking_admin_tenants(self, raw: bytes):
        """``POST /admin/tenants``: ``{"action": "add", "tenant":
        {...a manifest entry...}}`` registers a tenant without a
        redeploy (its model loads on its first query, under the budget);
        ``{"action": "remove", "app": ..., "variant": ...}`` stops new
        queries at once, drains the ones in flight and unloads.  404
        without tenancy; the anchor is never removable; a malformed spec
        answers 400.  The router broadcasts it to every replica."""
        from ..tenancy import TenantSpec

        js = "application/json"
        if self.tenants is None:
            return 404, {"message": "tenancy is not enabled"}, js
        try:
            doc = json.loads(raw.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return 400, {"message": f"invalid JSON: {e}"}, js
        action = doc.get("action")
        if action == "add":
            t = doc.get("tenant")
            if not isinstance(t, dict):
                return 400, {"message": "body needs a tenant{} object"}, js
            try:
                spec = TenantSpec(
                    app=t.get("app", ""),
                    variant=t.get("variant", "default"),
                    engine_json=t.get("engineJson"),
                    engine_name=t.get("engine"),
                    instance_id=t.get("engineInstanceId"),
                    access_key=t.get("accessKey"),
                    weight=float(t.get("weight", 1.0)),
                    pinned=bool(t.get("pinned", False)),
                    quota_qps=t.get("quotaQps"),
                    quota_burst=t.get("quotaBurst"),
                )
            except (TypeError, ValueError) as e:
                return 400, {"message": str(e)}, js
            # the app id and default access key, as deploy --multi
            # resolves them at boot
            try:
                md = self.ctx.storage.get_metadata()
                app_rec = md.app_get_by_name(spec.app)
                if app_rec is not None:
                    spec.app_id = app_rec.id
                    if spec.access_key is None:
                        keys = md.access_key_get_by_app(app_rec.id)
                        if keys:
                            spec.access_key = keys[0].key
            except Exception:
                logger.exception("tenant add: the metadata lookup failed; "
                                 "accessKey routing is off for %s",
                                 spec.key_str)
            try:
                return 200, self.tenants.add_tenant(spec), js
            except ValueError as e:
                return 400, {"message": str(e)}, js
        if action == "remove":
            app = doc.get("app")
            if not app:
                return 400, {"message": "remove needs an app"}, js
            try:
                out = self.tenants.remove_tenant(
                    (str(app), str(doc.get("variant", "default"))),
                    drain_timeout_s=float(doc.get("drainTimeoutSec", 10.0)),
                )
            except KeyError as e:  # UnknownTenant is a KeyError
                return 404, {"message": str(e)}, js
            except ValueError as e:
                return 400, {"message": str(e)}, js
            return 200, out, js
        return 400, {"message": "action must be 'add' or 'remove'"}, js

    # -- query path -------------------------------------------------------
    def _query_setup(self, query_json: dict, timeout_s: Optional[float],
                     tl, route=None) -> _QueryCtx:
        """The front half of a query on either edge: budget, tenant,
        decode, state snapshot, fault points, deadline-aware admission;
        marks the ``parse`` and ``auth`` timeline boundaries.  Blocks
        only while a tenant loads.  With tenancy the query resolves to
        its tenant first (its quota and breaker shed inside ``resolve``,
        before any decode), and a failure here completes the lease.
        ``route`` is the query's tenant route where the edge has taken
        it already."""
        budget = (timeout_s if timeout_s is not None
                  else self.config.query_timeout_s)
        deadline = Deadline.after(budget) if budget is not None else None
        lease = (self.tenants.resolve(query_json, route)
                 if self.tenants is not None else None)
        try:
            if lease is not None:
                rt = lease.runtime
                ctx = _QueryCtx(query_json, rt.query_decoder(query_json),
                                deadline, rt.algorithms, rt.models,
                                rt.serving, rt.batcher, lease)
                tl.mark("parse")
            else:
                query = self.query_decoder(query_json)
                tl.mark("parse")
                with self._lock:
                    ctx = _QueryCtx(query_json, query, deadline,
                                    self.algorithms, self.models,
                                    self.serving, self.batcher)
            faults.check("device.dispatch")
            if lease is not None:
                faults.check_tenant("tenant.dispatch", lease.key_str)
            tl.mark("auth")
            if deadline is not None:
                if ctx.batcher is not None:
                    ctx.batcher.check_admission(deadline)
                else:
                    deadline.check("query admission")
            return ctx
        except BaseException as e:
            if lease is not None:
                lease.complete(_outcome(e))
            raise

    def _query_finish(self, ctx: _QueryCtx, predictions, tl,
                      t0: float) -> Any:
        """The back half: serve, encode, and book the latency, span and
        flight record, on whatever thread completed the device work."""
        if ctx.deadline is not None:
            ctx.deadline.check("query serving")
        out = _result_to_json(ctx.serving.serve(ctx.query, predictions))
        lease = ctx.lease
        if lease is not None and isinstance(out, dict):
            # the assigned variant rides the reply, so clients can echo
            # it on their conversion events (what online eval counts)
            out = {**out, "variant": lease.variant}
        tl.mark("serialize")
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.last_serving_sec = dt
            instance_id = self.instance_id
            model = self if lease is None else lease.runtime
            freshness = time.monotonic() - model.model_advanced_mono
            foldin_seq = max(model.foldin_applied_seq.values(), default=0)
        # the trace id rides the histograms as a bucket exemplar and keys
        # the flight record: /metrics names a trace, the flight recorder
        # holds its span tree.  The segment split rides both the span and
        # the flight record (write lands only in the histogram family:
        # the record is taken before the socket write)
        tid = current_trace_id()
        self._latency.observe(dt, exemplar=tid)
        self._m_latency.observe(dt, exemplar=tid)
        self._m_engine_queries["ok"].inc()
        attrs = {
            "instance": instance_id,
            "engine": self.engine_name,
            "modelFreshnessSec": round(max(freshness, 0.0), 3),
            "segmentsMs": tl.snapshot_ms(),
        }
        if foldin_seq:
            attrs["foldinSeq"] = foldin_seq
        if lease is not None:
            # the tenant's latency histogram, the online-eval
            # impression, and the tenant and variant on the span
            attrs["tenant"] = lease.key_str
            attrs["variant"] = lease.variant
            lease.observe_latency(dt, exemplar=tid)
            self.tenants.online.impression(lease.runtime.spec.app,
                                           lease.variant)
        # back-dated to the request's start: the span covers its window
        get_tracer().record("serve.query", dt, attrs=attrs,
                            start=time.time() - dt)
        get_flight_recorder().offer(tid, dt, name="serve.query",
                                    attrs=attrs)
        if self.config.feedback and self.config.event_server_url:
            out = self._send_feedback(ctx.query_json, out, lease)
        if lease is not None:
            lease.complete("ok")
        return out

    def _send_feedback(self, query_json: dict, result_json: Any,
                       lease=None) -> Any:
        """Queue a ``pio_pr``/``predict`` feedback event (the query and
        the prediction) for the event server, under the query's trace
        id, and return the reply with the event's ``prId`` in it (the
        result's own ``prId``, or a new one).  A tenant's event carries
        its app and variant (the attribution online eval reads) and goes
        under its access key.  The delivery queue retries behind a
        circuit breaker, so a down event server neither stalls serving
        nor loses events below the queue's capacity."""
        pr_id = (
            result_json.get("prId") if isinstance(result_json, dict) else None
        ) or uuid.uuid4().hex
        props = {"query": query_json, "prediction": result_json}
        access_key = self.config.access_key
        if lease is not None:
            props["variant"] = lease.variant
            props["app"] = lease.runtime.spec.app
            if lease.runtime.spec.access_key:
                access_key = lease.runtime.spec.access_key
        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": props,
        }
        url = (f"{self.config.event_server_url}/events.json"
               f"?accessKey={access_key or ''}")
        tid = current_trace_id()
        self._feedback_queue.submit(
            url, event, headers={TRACE_HEADER: tid} if tid else None
        )
        if isinstance(result_json, dict):
            result_json = {**result_json, "prId": pr_id}
        return result_json

    def remote_log(self, message: str) -> None:
        """Ship a serving error to ``log_url`` (reference
        `CreateServer.scala:413-424` ``remoteLog``): POST ``log_prefix +
        json({engineInstance, message})`` through the delivery queue;
        delivery failures are retried, then counted, never raised."""
        if not self.config.log_url:
            return
        with self._lock:
            instance_id = self.instance_id
        payload = self.config.log_prefix + json.dumps({
            "engineInstance": {
                "id": instance_id,
                "engineId": self.engine_id,
                "engineVersion": self.engine_version,
                "engineVariant": self.engine_variant,
            },
            "message": message,
        })
        self._log_queue.submit(self.config.log_url, payload.encode())

    def _book_failure(self, e: BaseException, lease=None) -> tuple:
        """Book a failed query's outcome on the counters (and on its
        tenant's lease: completing a lease twice is a no-op); returns
        ``_error_reply(e)``'s code, payload and headers."""
        status, code, payload, headers = _error_reply(e)
        if lease is not None:
            lease.complete(status)
        self._m_queries[
            "rejected" if status in _TENANT_SHEDS else status].inc()
        self._m_engine_queries[status].inc()
        return code, payload, headers

    @staticmethod
    def _predict_direct(ctx: _QueryCtx) -> list:
        if ctx.deadline is not None:
            ctx.deadline.check("query device dispatch")
        return [algo.predict(model, ctx.query)
                for algo, model in zip(ctx.algorithms, ctx.models)]

    def predict_json(self, query_json: dict,
                     timeout_s: Optional[float] = None) -> Any:
        """Decode, predict (through the batcher when there is one),
        serve and encode one query; the blocking path of the threads
        edge and of direct library callers.  Adopts the HTTP handler's
        pulse timeline, or owns one for a direct caller."""
        tl = timeline.current_timeline()
        owned = tl is None
        if owned:
            tl = timeline.Timeline("serve")
        t0 = time.perf_counter()
        _m_inflight.inc()
        ctx = None
        try:
            with timeline.timeline_scope(tl), annotate("pio.serve.query"):
                ctx = self._query_setup(query_json, timeout_s, tl)
                if ctx.batcher is None:
                    predictions = self._predict_direct(ctx)
                    tl.mark("device")
                else:
                    if ctx.deadline is not None:
                        ctx.deadline.check("query device dispatch")
                    # the batcher books queue_wait/batch_wait/device
                    predictions = ctx.batcher.submit(ctx.query,
                                                     deadline=ctx.deadline)
                out = self._query_finish(ctx, predictions, tl, t0)
        except BaseException as e:
            # a setup failure completed its own lease; this books the
            # later ones (device, serve, deadline) on the tenant
            if ctx is not None and ctx.lease is not None:
                ctx.lease.complete(_outcome(e))
            raise
        finally:
            _m_inflight.dec()
        if owned:
            tl.finish()
        return out

    def latency_stats(self) -> dict:
        """Histogram-backed latency view for /status: the buckets
        /metrics exposes, so a curl of /status and a scrape of /metrics
        cannot disagree."""
        snap = self._latency.snapshot()
        if snap["count"] == 0:
            return {"count": 0, "avg": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        return {
            "count": snap["count"],
            "avg": snap["sum"] / snap["count"],
            "p50": self._latency.percentile(50, snap),
            "p95": self._latency.percentile(95, snap),
            "p99": self._latency.percentile(99, snap),
        }

    def status_json(self) -> dict:
        with self._lock:
            instance_id = self.instance_id
            request_count = self.request_count
            last_serving_sec = self.last_serving_sec
            batcher = self.batcher
            last_reload_error = self.last_reload_error
            models = list(getattr(self, "models", None) or ())
        lat = self.latency_stats()
        out = {
            "status": "alive",
            "engineInstanceId": instance_id,
            "engineId": self.engine_id,
            "engineVersion": self.engine_version,
            "engineVariant": self.engine_variant,
            "requestCount": request_count,
            "avgServingSec": lat["avg"],
            "lastServingSec": last_serving_sec,
            "p50ServingSec": lat["p50"],
            "p95ServingSec": lat["p95"],
            "p99ServingSec": lat["p99"],
            "startTime": self.start_time,
            "device": str(self.ctx.device),
            "resilience": {
                "lastReloadError": last_reload_error,
                "queryTimeoutSec": self.config.query_timeout_s,
                "feedback": self._feedback_queue.stats(),
                "remoteLog": self._log_queue.stats(),
            },
        }
        if batcher is not None:
            out["microbatch"] = batcher.stats()
        # pio-live: model freshness and watermark lag (absent when off)
        out.update(self._foldin_status())
        # the registry's residency and budget counters (each tenant's
        # detail is on /debug/tenants)
        if self.tenants is not None:
            out["tenancy"] = self.tenants.summary()
        # a model served through the ring top-k (distributedTopk): its
        # shards, killed shards, degraded polls and parity owner
        rings = [m._sharded_topk for m in models
                 if getattr(m, "_sharded_topk", None) is not None]
        if rings:
            out["distributedTopk"] = rings[0].summary()
        # the worst-N flight records (span trees on /debug/xray) and the
        # histogram's bucket exemplars: /status alone links a slow bucket
        # to a trace id
        out["xray"] = {
            "flight": get_flight_recorder().summary(),
            "latencyExemplars": [
                {"le": le, "traceId": ex, "value": v}
                for le, ex, v, _ts in self._latency.exemplar_items()
            ],
        }
        return out

    def status_html(self) -> str:
        """Browser view of the deployed engine (the reference's Twirl
        status page, `core/src/main/twirl/io/prediction/workflow/
        index.scala.html`): engine and server information and each
        component's params; content-negotiated on ``/``."""
        import html as _html

        from ..controller.params import params_to_json

        def esc(v) -> str:
            return _html.escape(str(v))

        def row(k, v) -> str:
            return f"<tr><th>{esc(k)}</th><td>{esc(v)}</td></tr>"

        def table(rows) -> str:
            return ("<table border='1' cellpadding='4'>" + "".join(rows)
                    + "</table>")

        with self._lock:
            instance_id = self.instance_id
            request_count = self.request_count
            last_serving_sec = self.last_serving_sec
            ep = self.engine_params
        lat = self.latency_stats()
        rec = self.ctx.storage.get_metadata().engine_instance_get(
            instance_id
        )
        engine_rows = [
            row("Instance ID", instance_id),
            row("Engine ID", self.engine_id),
            row("Engine Version", self.engine_version),
            row("Variant", self.engine_variant),
        ]
        if rec is not None:
            engine_rows += [
                row("Training Start Time", rec.start_time),
                row("Training End Time", rec.end_time),
            ]
        started = time.strftime(
            "%Y-%m-%d %H:%M:%S UTC", time.gmtime(self.start_time)
        )
        server_rows = [
            row("Start Time", started),
            row("Request Count", request_count),
            row("Average Serving Time", f"{lat['avg']:.4f} s"),
            row("Last Serving Time", f"{last_serving_sec:.4f} s"),
            row("Serving Time p50 / p95 / p99",
                f"{lat['p50']:.4f} / {lat['p95']:.4f} / "
                f"{lat['p99']:.4f} s"),
        ]
        live = self._foldin_status()
        if live:
            server_rows.append(row(
                "Model Freshness (fold-in)",
                f"{live['modelFreshnessSec']:.1f} s since last advance; "
                f"watermark lag {live['foldinWatermarkLag']} rows; "
                f"{live['foldinDeltasApplied']} deltas applied",
            ))
        worst = get_flight_recorder().summary()["worst"]
        if worst:
            server_rows.append(row(
                "Slowest Requests (flight recorder)",
                "; ".join(
                    f"{w['traceId']} {w['durationSec'] * 1e3:.1f} ms"
                    for w in worst[:5]
                ) + " — span trees at /debug/xray",
            ))
        comp_rows = [
            row(f"Data Source [{ep.data_source[0] or 'default'}]",
                json.dumps(params_to_json(ep.data_source[1]))),
            row(f"Preparator [{ep.preparator[0] or 'default'}]",
                json.dumps(params_to_json(ep.preparator[1]))),
        ]
        for name, p in ep.algorithms:
            comp_rows.append(
                row(f"Algorithm [{name or 'default'}]",
                    json.dumps(params_to_json(p)))
            )
        comp_rows.append(
            row(f"Serving [{ep.serving[0] or 'default'}]",
                json.dumps(params_to_json(ep.serving[1])))
        )
        title = f"Engine Server at {self.config.host}:{self.config.port}"
        return (
            "<!DOCTYPE html><html><head>"
            f"<title>{esc(title)}</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace}</style></head><body>"
            f"<h1>{esc(title)}</h1>"
            "<h2>Engine Information</h2>" + table(engine_rows) +
            "<h2>Server Information</h2>" + table(server_rows) +
            "<h2>Components</h2>" + table(comp_rows) +
            "<p>POST queries to <code>/queries.json</code>.</p>"
            "</body></html>"
        )

    # -- event-loop edge ----------------------------------------------------
    def _build_httpd(self):
        if self.config.edge != "eventloop":
            return super()._build_httpd()
        if self._aux_pool is None:
            # blocking routes only (status, reload, unbatched predicts);
            # the batched query path never lands here
            self._aux_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="serve-aux",
            )
        return EventLoopHTTPServer(
            (self.host, self.port), self._el_handle,
            max_connections=self.config.max_connections,
            name=self.server_name,
        )

    def _aux_submit(self, respond, fn) -> None:
        """Hand a blocking route to the aux pool; once the pool is gone
        (server stopping) answer 503 instead of crashing the loop."""
        pool = self._aux_pool
        if pool is not None:
            try:
                pool.submit(fn)
                return
            except RuntimeError:  # shut down meanwhile
                pass
        try:
            respond(503, {"message": "server is stopping"})
        except RuntimeError:
            pass  # already answered

    def _aux(self, respond, fn, *args) -> None:
        """Run ``fn(*args) -> (code, payload, ctype)`` on the aux pool
        and answer from there."""
        def run():
            try:
                code, payload, ctype = fn(*args)
                respond(code, payload, ctype=ctype)
            except Exception as e:
                logger.exception("aux route failed")
                try:
                    respond(500, {"message": str(e)})
                except RuntimeError:
                    pass  # the route answered before raising

        self._aux_submit(respond, run)

    @callback_scope
    def _el_handle(self, req, respond) -> None:
        """Event-loop request router, ON the loop thread: every branch
        answers from memory or hands off without blocking."""
        u = urllib.parse.urlparse(req.path)
        if req.method == "POST":
            if u.path == "/queries.json":
                self._el_query(req, u.query, respond)
            elif u.path == "/stop":
                respond(200, {"message": "stopping"})
                threading.Thread(target=self.stop, daemon=True).start()
            elif u.path == "/foldin/apply":
                self._aux(respond, self._blocking_foldin_apply)
            elif u.path == "/tenants/weights":
                self._aux(respond, self._blocking_set_weights, req.body)
            elif u.path == "/admin/tenants":
                self._aux(respond, self._blocking_admin_tenants, req.body)
            else:
                respond(404, {"message": "not found"})
            return
        if req.method == "GET":
            # every GET (the observability mounts included: a profile
            # capture blocks for seconds) runs on the aux pool
            self._aux(respond, self._blocking_get, u.path, u.query,
                      req.header("Accept") or "")
            return
        respond(405, {"message": f"method {req.method} not allowed"})

    def _blocking_get(self, path: str, query: str, accept: str = ""):
        """``(code, payload, ctype)`` of a GET route, for both edges (on
        the event-loop edge it runs on the aux pool); ``/`` answers the
        HTML status page to an ``Accept`` naming ``text/html``."""
        ans = observability_response(path, query)
        if ans is not None:
            code, payload, ctype = ans
            return code, payload, ctype or "application/json"
        js = "application/json"
        if path == "/debug/tenants":
            if self.tenants is None:
                return (404, {"message": "tenancy is not enabled "
                              "(deploy --multi)"}, js)
            return 200, self.tenants.debug_payload(), js
        if path == "/debug/experiments":
            return (*_experiments_response(self.tenants), js)
        if path == "/":
            if "text/html" in accept:
                return (200, self.status_html().encode(),
                        "text/html; charset=utf-8")
            return 200, self.status_json(), js
        if path == "/reload":
            try:
                return 200, {"reloaded": self.reload()}, js
            except LookupError as e:
                return 404, {"message": str(e)}, js
            except Exception as e:
                logger.exception("reload failed")
                return 500, {"message": f"reload failed: {e}"}, js
        return 404, {"message": "not found"}, js

    @callback_scope
    def _el_query(self, req, query_str: str, respond) -> None:
        """The continuous hot path: parse and admission on the loop
        thread, device work on the batcher's dispatcher, serve/encode in
        its callback, the socket write back on the loop (which finishes
        the request's timeline).  The request's trace id (its
        ``X-PIO-Trace``, or a new one) is echoed on every reply.  A
        query whose tenant must load first is set up on the aux pool, so
        the loop goes on answering the resident tenants meanwhile."""
        tid = (req.header(TRACE_HEADER) or "").strip() or new_trace_id()
        hdrs = [(TRACE_HEADER, tid)]
        tl = timeline.Timeline("serve")
        query_json, timeout_s, bad = _parse_query(req.body, query_str)
        if bad is not None:
            self._m_queries["bad_request"].inc()
            respond(400, {"message": bad}, extra_headers=hdrs)
            return
        route = None
        if self.tenants is not None:
            try:
                route = self.tenants.route(query_json)
            except Exception as e:  # UnknownTenant, or not a JSON object
                self._el_reply_error(e, respond, hdrs)
                return
            if not self.tenants.is_resident(route[0]):
                self._aux_submit(respond, lambda: self._el_dispatch(
                    query_json, timeout_s, tid, hdrs, tl, respond, route))
                return
        self._el_dispatch(query_json, timeout_s, tid, hdrs, tl, respond,
                          route)

    def _el_dispatch(self, query_json, timeout_s, tid, hdrs, tl,
                     respond, route=None) -> None:
        """The query's setup and hand-off to the device, on the loop
        thread or, while its tenant loads, on the aux pool."""
        _m_inflight.inc()
        try:
            with trace_scope(tid), timeline.timeline_scope(tl):
                ctx = self._query_setup(query_json, timeout_s, tl,
                                        route)
        except Exception as e:
            _m_inflight.dec()
            self._el_reply_error(e, respond, hdrs)
            return

        if ctx.batcher is None:
            # no batched path: the per-query predict is blocking device
            # work, so it goes to the aux pool, not the loop
            def run_direct():
                try:
                    with trace_scope(tid), timeline.timeline_scope(tl), \
                            annotate("pio.serve.query"):
                        predictions = self._predict_direct(ctx)
                        tl.mark("device")
                        out = self._query_finish(ctx, predictions, tl,
                                                 tl.t0)
                except Exception as e:
                    _m_inflight.dec()
                    self._el_reply_error(e, respond, hdrs, ctx.lease)
                    return
                _m_inflight.dec()
                self._m_queries["ok"].inc()
                respond(200, out, extra_headers=hdrs, tl=tl)

            self._aux_submit(respond, run_direct)
            return

        def done(entry):
            # on the dispatcher thread, once the entry has its result
            # and its queue_wait/batch_wait/device segments are booked
            err = entry.error
            out = None
            if err is None:
                try:
                    with trace_scope(tid):
                        out = self._query_finish(ctx, entry.value, tl,
                                                 tl.t0)
                except Exception as e:
                    err = e
            _m_inflight.dec()
            if err is not None:
                self._el_reply_error(err, respond, hdrs, ctx.lease)
                return
            self._m_queries["ok"].inc()
            respond(200, out, extra_headers=hdrs, tl=tl)

        try:
            ctx.batcher.submit_nowait(ctx.query, done, deadline=ctx.deadline,
                                      timeline=tl)
        except RuntimeError:
            # the snapshot raced a reload that closed this batcher: retry
            # once on the current one (the anchor's path only: a
            # tenant's batcher goes only with its own runtime)
            with self._lock:
                batcher = self.batcher
            if (ctx.lease is None and batcher is not None
                    and batcher is not ctx.batcher):
                ctx.batcher = batcher
                batcher.submit_nowait(ctx.query, done,
                                      deadline=ctx.deadline, timeline=tl)
            else:
                _m_inflight.dec()
                self._el_reply_error(
                    RuntimeError("batcher unavailable during reload"),
                    respond, hdrs, ctx.lease)

    def _el_reply_error(self, e: BaseException, respond, hdrs,
                        lease=None) -> None:
        code, payload, headers = self._book_failure(e, lease)
        # queued before the reply: a client that reads its 400 or 500
        # finds the log entry already submitted
        if code == 400:
            self.remote_log(f"Query is invalid: {e}")
        elif code == 500:
            self.remote_log(f"Query failed: {e}")
        try:
            respond(code, payload, extra_headers=hdrs + headers)
        except RuntimeError:
            pass  # request already answered

    def stop(self) -> None:
        # the whole teardown under one lock: a second caller (the deploy
        # command, once POST /stop has ended its loop) returns only when
        # the first has finished
        with self._teardown_lock:
            super().stop()
            self._foldin_stop.set()  # the delta poll exits
            self._eval_stop.set()  # and the online-eval loop
            if self.tenants is not None:
                self.tenants.close()
            # release the batcher's dispatcher and the aux pool, waiting
            # for their threads (pending entries drain first)
            with self._lock:
                batcher = getattr(self, "batcher", None)
            if batcher is not None:
                batcher.close()
            # a view's close only retires its tenant: the shared core and
            # its dispatcher are the server's to stop
            with self._shared_lock:
                core, self._shared_core = self._shared_core, None
            if core is not None:
                core.close()
            pool, self._aux_pool = self._aux_pool, None
            if pool is not None:
                pool.shutdown(wait=True)
            # the delivery drain threads exit once their queues are
            # empty (what is still queued is abandoned with the process)
            self._feedback_queue.close()
            self._log_queue.close()

    # -- http --------------------------------------------------------------
    @property
    def host(self) -> str:
        return self.config.host

    @property
    def port(self) -> int:
        return self.config.port

    @port.setter
    def port(self, v: int) -> None:
        self.config.port = v

    @property
    def max_connections(self) -> int:
        return self.config.max_connections

    def _make_handler(server: "EngineServer"):
        # the blocking POST routes, each a function of the body
        routes = {
            "/foldin/apply": lambda raw: server._blocking_foldin_apply(),
            "/tenants/weights": server._blocking_set_weights,
            "/admin/tenants": server._blocking_admin_tenants,
        }

        class Handler(JsonRequestHandler):
            server_logger = logger

            def do_GET(self):
                u = urllib.parse.urlparse(self.path)
                code, payload, ctype = server._blocking_get(
                    u.path, u.query, self.headers.get("Accept", ""))
                self._reply(code, payload, ctype=ctype)

            def do_POST(self):
                raw = self._body()  # read on every route: keep-alive
                u = urllib.parse.urlparse(self.path)
                if u.path == "/queries.json":
                    # honor the client's X-PIO-Trace or mint one; echoed
                    # on the reply.  The handler owns the pulse timeline:
                    # its t0 precedes the decode, and only it can time
                    # the socket write
                    tid = self._trace_id() or new_trace_id()
                    self.extra_headers = [(TRACE_HEADER, tid)]
                    tl = timeline.Timeline("serve")
                    try:
                        with trace_scope(tid), timeline.timeline_scope(tl):
                            self._post_query(raw, u.query, tl)
                    finally:
                        self.extra_headers = []
                elif u.path == "/stop":
                    self._reply(200, {"message": "stopping"})
                    threading.Thread(target=server.stop, daemon=True).start()
                elif u.path in routes:
                    try:
                        code, payload, _ = routes[u.path](raw)
                    except Exception as e:
                        logger.exception("%s failed", u.path)
                        code, payload = 500, {"message": str(e)}
                    self._reply(code, payload)
                else:
                    self._reply(404, {"message": "not found"})

            def _post_query(self, raw: bytes, query_str: str, tl) -> None:
                query_json, timeout_s, bad = _parse_query(raw, query_str)
                if bad is not None:
                    server._m_queries["bad_request"].inc()
                    self._reply(400, {"message": bad})
                    return
                try:
                    out = server.predict_json(query_json,
                                              timeout_s=timeout_s)
                except Exception as e:
                    code, payload, headers = server._book_failure(e)
                    self.extra_headers += headers
                    # queued before the reply, as on the event-loop edge
                    what = {400: "is invalid", 500: "failed"}.get(code)
                    if what is not None:
                        server.remote_log(
                            f"Query {raw.decode(errors='replace')} "
                            f"{what}: {e}")
                    self._reply(code, payload)
                    return
                self._reply(200, out)
                # close the timeline on the success path only: error
                # replies have no meaningful decomposition
                tl.mark("write")
                tl.finish()
                server._m_queries["ok"].inc()

        return Handler
