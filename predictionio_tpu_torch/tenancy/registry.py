"""pio-hive: the memory-budgeted multi-tenant model registry.

Port of ``predictionio_tpu/tenancy/registry.py``.  One
:class:`TenantRegistry` turns one serving process into many: N (app,
engine_variant) models behind one port, loaded lazily on first query,
kept under a configurable memory budget with LRU eviction and pinning,
each with its own circuit breaker, token-bucket quota, fold-in state
and metric label set, so one tenant's open breaker, quota exhaustion
or fold-in push cannot move another tenant's error rate.

* **Budget math**: a tenant's resident cost is
  :func:`model_resident_bytes`: every numpy array and torch tensor
  (host or card) reachable from its models (factor tables, id indexes,
  the device item tables the warm-up makes), deduplicated by identity.
  The ``pio_device_memory_bytes`` gauges are resampled after every load
  and eviction, so the allocator's view and the accounting meet on one
  ``/metrics`` scrape.
* **Eviction safety**: eviction only takes tenants that are neither
  pinned nor serving a query (a per-tenant lease count).  A query that
  snapshotted its components keeps them alive by reference, so an
  eviction never fails a request in flight; it costs the next request
  a reload.  An evicted runtime drops its components and its batcher
  view, so its CUDA tensors are freed when the last query holding them
  ends.
* **LRU determinism**: recency is an integer tick, not a clock, so a
  seeded access pattern gives the same eviction sequence every run.
* **Loading off-lock**: a lazy load runs outside the registry lock
  behind a per-key event; queries for other tenants never wait behind
  it, and queries for the same tenant wait for the one load.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from ..obs import (
    FOLDIN_APPLIES_TOTAL,
    TENANT_LOADS_TOTAL,
    TENANT_MEMORY_BUDGET,
    TENANT_PLACEMENT_BALANCE,
    TENANT_QUERIES_TOTAL,
    TENANT_QUERY_LATENCY,
    TENANT_QUOTA_REJECTED,
    TENANT_RESIDENT_BYTES,
    TENANTS_RESIDENT,
    get_tracer,
    scope,
)
from ..resilience.policy import CircuitBreaker
from .errors import QuotaExceeded, TenantUnavailable, UnknownTenant
from .experiment import Experiment
from .online_eval import OnlineEval
from .quota import TokenBucket

__all__ = [
    "TenantLease",
    "TenantRegistry",
    "TenantRuntime",
    "TenantSpec",
    "load_tenant_manifest",
    "model_resident_bytes",
]

logger = logging.getLogger(__name__)

# per-tenant serving outcome label values (the ones complete() books)
_STATUSES = (
    "ok", "error", "timeout", "rejected", "quota", "bad_request", "shed",
)
# outcomes that count as tenant-breaker failures: real faults and
# overload sheds open it (isolation), client mistakes close it
_BREAKER_FAILURES = frozenset(("error", "timeout", "rejected"))


def model_resident_bytes(models) -> int:
    """Accounted bytes of a tenant's model objects: every array or
    tensor with ``nbytes`` (numpy on the host, torch on the host or the
    card) reachable from the models' attribute graphs to a small depth,
    deduplicated by identity: factor tables, id indexes, cached device
    tables."""
    seen: set[int] = set()

    def walk(obj: Any, depth: int) -> int:
        if obj is None or isinstance(obj, (str, bytes, int, float, bool)):
            return 0
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        nbytes = getattr(obj, "nbytes", None)
        if nbytes is not None:
            try:
                return int(nbytes)
            except (TypeError, ValueError):
                return 0
        if depth <= 0:
            return 0
        total = 0
        if isinstance(obj, dict):
            for v in obj.values():
                total += walk(v, depth - 1)
            return total
        if isinstance(obj, (list, tuple, set)):
            for v in obj:
                total += walk(v, depth - 1)
            return total
        d = getattr(obj, "__dict__", None)
        if d:
            for v in d.values():
                total += walk(v, depth - 1)
        return total

    return sum(walk(m, 4) for m in models)


class TenantSpec:
    """Declaration of one (app, engine_variant) tenant.

    Either ``engine_json`` (resolved by the server's loader at first
    query) or prebuilt ``engine``/``engine_params``/``instance_id``
    (programmatic callers: benches, tests) must be provided.
    """

    def __init__(self, app: str, variant: str = "default",
                 engine_json: Optional[str] = None,
                 engine=None, engine_params=None,
                 instance_id: Optional[str] = None,
                 ctx=None,
                 app_id: Optional[int] = None,
                 access_key: Optional[str] = None,
                 weight: float = 1.0,
                 pinned: bool = False,
                 quota_qps: Optional[float] = None,
                 quota_burst: Optional[float] = None,
                 engine_name: Optional[str] = None):
        if not app:
            raise ValueError("tenant spec needs a non-empty app name")
        if not variant:
            raise ValueError("tenant spec needs a non-empty variant name")
        if engine_json is None and engine is None and engine_name is None:
            raise ValueError(
                f"tenant {app}/{variant}: provide engine_json, a "
                "registered engine name, or a prebuilt engine"
            )
        if not (weight >= 0.0):
            raise ValueError(
                f"tenant {app}/{variant}: weight must be >= 0, "
                f"got {weight}"
            )
        self.app = str(app)
        self.variant = str(variant)
        self.engine_json = engine_json
        # pio-forge: a tenants.json entry may name any REGISTERED
        # engine ("engine": "trending") instead of an engine.json path;
        # the loader resolves it through the registry, and the trained
        # instance is looked up under the `engine:<name>` variant key
        self.engine_name = engine_name
        self.engine = engine
        self.engine_params = engine_params
        self.instance_id = instance_id
        self.ctx = ctx
        self.app_id = app_id
        self.access_key = access_key
        self.weight = float(weight)
        self.pinned = bool(pinned)
        self.quota_qps = quota_qps
        self.quota_burst = quota_burst

    @property
    def key(self) -> tuple[str, str]:
        return (self.app, self.variant)

    @property
    def key_str(self) -> str:
        return f"{self.app}/{self.variant}"


class TenantRuntime:
    """One resident tenant's serving state: the same component set an
    ``EngineServer`` holds for its single model, plus the per-tenant
    resilience/quota/metric objects.  A passive holder — all mutable
    bookkeeping (inflight, recency, fold-in fields) is guarded by the
    OWNING registry's lock."""

    def __init__(self, spec: TenantSpec, engine, engine_params,
                 instance_id: str, algorithms, models, serving, batcher,
                 query_decoder, ctx,
                 breaker: Optional[CircuitBreaker] = None,
                 quota: Optional[TokenBucket] = None):
        self.spec = spec
        self.key = spec.key
        self.key_str = spec.key_str
        self.engine = engine
        self.engine_params = engine_params
        self.instance_id = instance_id
        self.algorithms = algorithms
        self.models = models
        self.serving = serving
        self.batcher = batcher
        self.query_decoder = query_decoder
        self.ctx = ctx
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=5, reset_timeout_s=10.0
        )
        self.quota = quota
        self.pinned = spec.pinned
        self.is_anchor = False
        self.resident_bytes = model_resident_bytes(models)
        self.loaded_at = time.time()  # wall clock: a TIMESTAMP
        # registry-guarded bookkeeping
        self.last_used = 0
        self.inflight = 0
        self.requests = 0
        # pio-live per-tenant fold-in state (mirrors EngineServer's)
        self.foldin_applied_seq: dict = {}
        self.foldin_deltas_applied = 0
        self.last_foldin_error: Optional[str] = None
        self.model_advanced_mono = time.monotonic()
        # labeled children resolved once (.labels() is too hot for the
        # per-request path)
        app, variant = spec.key
        self.m_queries = {
            s: TENANT_QUERIES_TOTAL.labels(app=app, variant=variant,
                                           status=s)
            for s in _STATUSES
        }
        self.m_latency = TENANT_QUERY_LATENCY.labels(
            app=app, variant=variant
        )
        self.m_quota = TENANT_QUOTA_REJECTED.labels(
            app=app, variant=variant
        )
        self.m_resident = TENANT_RESIDENT_BYTES.labels(
            app=app, variant=variant
        )

    def snapshot(self) -> dict:
        """Status view; reads of registry-guarded counters are benign
        torn reads of ints (display only)."""
        out = {
            "app": self.spec.app,
            "variant": self.spec.variant,
            "instanceId": self.instance_id,
            "residentBytes": self.resident_bytes,
            "pinned": self.pinned,
            "anchor": self.is_anchor,
            "inflight": self.inflight,
            "requests": self.requests,
            "breaker": self.breaker.state,
            "foldinDeltasApplied": self.foldin_deltas_applied,
            "modelFreshnessSec": round(
                max(time.monotonic() - self.model_advanced_mono, 0.0), 3
            ),
        }
        if self.quota is not None:
            out["quota"] = self.quota.snapshot()
        if self.last_foldin_error:
            out["lastFoldinError"] = self.last_foldin_error
        return out


class TenantLease:
    """One query's hold on a tenant: pins it against eviction (via the
    inflight count) and books the outcome exactly once."""

    __slots__ = ("registry", "runtime", "variant", "assigned", "_done")

    def __init__(self, registry: "TenantRegistry", runtime: TenantRuntime,
                 variant: str, assigned: bool):
        self.registry = registry
        self.runtime = runtime
        self.variant = variant
        self.assigned = assigned  # True = experiment-assigned, not explicit
        self._done = False

    @property
    def key_str(self) -> str:
        return self.runtime.key_str

    def observe_latency(self, seconds: float, exemplar=None) -> None:
        self.runtime.m_latency.observe(seconds, exemplar=exemplar)

    def complete(self, status: str) -> None:
        """Book the per-tenant outcome + breaker signal and release the
        eviction pin.  Idempotent — success and error paths may race on
        the event-loop edge."""
        if self._done:
            return
        self._done = True
        rt = self.runtime
        rt.m_queries.get(status, rt.m_queries["error"]).inc()
        if status == "quota":
            rt.m_quota.inc()
        if status in _BREAKER_FAILURES:
            rt.breaker.record_failure()
        else:
            rt.breaker.record_success()
        self.registry._release(rt)


class TenantRegistry:
    """See module docstring.  ``loader`` is injected (the serving layer
    provides one that builds real components; tests inject fakes) —
    ``loader(spec) -> TenantRuntime``."""

    # how long a query waits on another thread's in-progress load of
    # the same tenant before shedding (the load itself is bounded by
    # whatever the loader does; this bounds the WAITERS)
    load_wait_s = 120.0

    def __init__(self, specs, memory_budget_bytes: Optional[float] = None,
                 salt: str = "pio-hive",
                 loader: Optional[Callable[[TenantSpec], TenantRuntime]] = None,
                 default_quota_qps: Optional[float] = None,
                 eval_interval_s: float = 5.0,
                 autopilot: Optional[dict] = None):
        specs = list(specs)
        if not specs:
            raise ValueError("tenant registry needs >= 1 tenant spec")
        # pio-scope: every tenant lookup/load/evict serializes here —
        # multi-tenant p99 stalls show up as this lock's wait histogram
        self._lock = scope.TimedLock("tenant_registry", reentrant=True)
        self._specs: dict[tuple[str, str], TenantSpec] = {}
        for s in specs:
            if s.key in self._specs:
                raise ValueError(f"duplicate tenant spec {s.key_str}")
            if s.quota_qps is None and default_quota_qps is not None:
                s.quota_qps = default_quota_qps
            self._specs[s.key] = s
        self.anchor_key = specs[0].key
        self.salt = salt
        self.loader = loader
        self.default_quota_qps = default_quota_qps
        self.eval_interval_s = eval_interval_s
        self.memory_budget_bytes = (
            int(memory_budget_bytes) if memory_budget_bytes else 0
        )
        TENANT_MEMORY_BUDGET.child().set(float(self.memory_budget_bytes))
        # one experiment per app over that app's variants
        by_app: dict[str, dict[str, float]] = {}
        for s in specs:
            by_app.setdefault(s.app, {})[s.variant] = s.weight
        self._experiments = {
            app: Experiment(app, weights, salt=salt)
            for app, weights in by_app.items()
        }
        self._by_access_key = {
            s.access_key: s.app for s in specs if s.access_key
        }
        self._runtimes: dict[tuple[str, str], TenantRuntime] = {}
        self._loading: dict[tuple[str, str], threading.Event] = {}
        self._tick = 0
        self.loads = 0
        self.evictions = 0
        self.overcommits = 0
        # pio-confluence: budget evictions performed to make room for
        # an INCOMING tenant (the registry rebalancing placement, as
        # opposed to an admin shrink/evict) — paired with the
        # pio_tenant_placement_balance gauge
        self.rebalances = 0
        self.online = OnlineEval(salt=salt)
        # pio-pilot: the self-driving experiment controller (opt-in via
        # enable_autopilot() or the tenants.json "autopilot" block; the
        # serving online-eval loop drives its tick right after each
        # conversion refresh)
        self.autopilot = None
        if autopilot is not None:
            self.enable_autopilot(config=autopilot)

    # -- spec / experiment views ------------------------------------------
    def specs(self) -> list[TenantSpec]:
        with self._lock:
            return list(self._specs.values())

    def spec(self, key: tuple[str, str]) -> TenantSpec:
        with self._lock:
            s = self._specs.get(key)
        if s is None:
            raise UnknownTenant(f"unknown tenant {key}")
        return s

    def apps(self) -> list[str]:
        with self._lock:
            return sorted(self._experiments)

    def experiment(self, app: str) -> Experiment:
        with self._lock:
            exp = self._experiments.get(app)
        if exp is None:
            raise UnknownTenant(f"unknown app {app!r}")
        return exp

    def set_weights(self, app: str, weights: dict) -> dict:
        """Hot-update an app's variant weights; returns the new
        snapshot (the admin-API/router-broadcast primitive)."""
        exp = self.experiment(app)
        exp.set_weights({str(k): float(v) for k, v in weights.items()})
        return exp.snapshot()

    def deficit_weight(self, key: tuple[str, str]) -> float:
        """One tenant's share weight for the shared batcher's claim-time
        deficit round-robin (pio-confluence): its variant weight
        normalized by its app's total, so an app splitting traffic
        90/10 across variants claims device share 90/10 too, and apps
        are peers.  Reads the LIVE experiment weights — a hot ``POST
        /tenants/weights`` reshapes the next dispatcher claim with no
        push plumbing.  Unknown tenants weigh 1.0 (never let a
        scheduling lookup shed a query)."""
        app, variant = key
        with self._lock:
            exp = self._experiments.get(app)
            if exp is None:
                return 1.0
            weights = exp.weights()
        w = weights.get(variant)
        if w is None:
            return 1.0
        total = sum(weights.values())
        return w / total if total > 0 else 1.0

    # -- lifecycle admin (POST /admin/tenants) -----------------------------
    def add_tenant(self, spec: TenantSpec) -> dict:
        """Live-add a tenant without a redeploy.  The spec
        registers immediately; the model loads lazily on first query
        exactly like a boot-manifest tenant (budget eviction applies).
        Adding a new variant to an existing app rebuilds that app's
        experiment with the extended weight set — sticky assignment is
        pure hash math, so existing variants' users keep their
        assignment except for the interval mass the new weight
        claims."""
        with self._lock:
            if spec.key in self._specs:
                raise ValueError(
                    f"tenant {spec.key_str} already exists"
                )
            if spec.quota_qps is None and self.default_quota_qps is not None:
                spec.quota_qps = self.default_quota_qps
            self._specs[spec.key] = spec
            exp = self._experiments.get(spec.app)
            weights = dict(exp.weights()) if exp is not None else {}
            weights[spec.variant] = spec.weight
            self._experiments[spec.app] = Experiment(
                spec.app, weights, salt=self.salt
            )
            if spec.access_key:
                self._by_access_key[spec.access_key] = spec.app
            new_weights = self._experiments[spec.app].weights()
        TENANT_LOADS_TOTAL.labels(
            app=spec.app, variant=spec.variant, kind="admin_add"
        ).inc()
        logger.info("tenant %s added live", spec.key_str)
        return {"added": spec.key_str, "weights": new_weights}

    def remove_tenant(self, key: tuple[str, str],
                      drain_timeout_s: float = 10.0) -> dict:
        """Live-remove a tenant: new queries stop resolving to it
        IMMEDIATELY (spec + experiment variant dropped under the lock),
        then the resident model waits for its in-flight leases to
        drain — the same in-flight safety the eviction path enforces,
        made blocking — before unload.  The anchor tenant is refused
        (it IS the process's base components).  Returns
        ``{"removed", "drained", "wasResident"}``; ``drained=False``
        means the drain timed out and the runtime was unloaded with
        leases still open (logged loudly)."""
        key = (str(key[0]), str(key[1]))
        with self._lock:
            spec = self._specs.get(key)
            if spec is None:
                raise UnknownTenant(f"unknown tenant {key}")
            if key == self.anchor_key:
                raise ValueError(
                    "cannot remove the anchor tenant (it is the "
                    "server's own model); redeploy instead"
                )
            del self._specs[key]
            app, variant = key
            exp = self._experiments.get(app)
            if exp is not None:
                weights = dict(exp.weights())
                weights.pop(variant, None)
                if weights and sum(weights.values()) > 0:
                    self._experiments[app] = Experiment(
                        app, weights, salt=self.salt
                    )
                else:
                    # last variant of the app: the app itself goes
                    del self._experiments[app]
            if spec.access_key:
                self._by_access_key.pop(spec.access_key, None)
            rt = self._runtimes.get(key)
        drained = True
        if rt is not None:
            deadline = time.monotonic() + max(drain_timeout_s, 0.0)
            while True:
                with self._lock:
                    if rt.inflight == 0:
                        self._runtimes.pop(key, None)
                        self._book_residency_locked(rt, "admin_remove")
                        break
                if time.monotonic() > deadline:
                    drained = False
                    logger.warning(
                        "tenant %s removal drain timed out with %d "
                        "leases in flight; unloading anyway",
                        spec.key_str, rt.inflight,
                    )
                    with self._lock:
                        self._runtimes.pop(key, None)
                        self._book_residency_locked(rt, "admin_remove")
                    break
                time.sleep(0.005)
            self._close_runtime(rt)
            self._sample_device_memory()
        logger.info("tenant %s removed (drained=%s)", spec.key_str,
                    drained)
        return {"removed": spec.key_str, "drained": drained,
                "wasResident": rt is not None}

    # -- resolution (the per-query hot path) ------------------------------
    def resolve(self, query_json: dict,
                route: Optional[tuple[tuple[str, str], str, bool]] = None,
                ) -> TenantLease:
        """Route one query to its tenant: explicit ``app``/``appId`` +
        ``variant`` fields win, an ``accessKey`` field maps to its app,
        anything else lands on the anchor tenant; a missing variant is
        assigned by the app's experiment from the ``user`` field
        (sticky weighted A/B).  Applies quota THEN breaker admission,
        loads the model lazily, and returns a lease pinning the tenant
        for the query's duration.  ``route`` is the query's
        :meth:`route`, where the caller has taken it already."""
        key, variant, assigned = (route if route is not None
                                  else self.route(query_json))
        rt = self.get_runtime(key)
        # quota before the breaker: allow() may claim the single
        # half-open probe slot, which a quota shed would then strand
        if rt.quota is not None and not rt.quota.try_acquire():
            rt.m_queries["quota"].inc()
            rt.m_quota.inc()
            raise QuotaExceeded(
                f"tenant {rt.key_str} is over its "
                f"{rt.quota.rate_qps:g} QPS quota"
            )
        if not rt.breaker.allow():
            rt.m_queries["shed"].inc()
            raise TenantUnavailable(
                f"tenant {rt.key_str} breaker is open "
                "(shedding after repeated failures)"
            )
        with self._lock:
            self._tick += 1
            rt.last_used = self._tick
            rt.inflight += 1
            rt.requests += 1
        return TenantLease(self, rt, variant, assigned)

    def is_resident(self, key: tuple[str, str]) -> bool:
        """Whether the tenant ``key`` is loaded, so that :meth:`resolve`
        takes it without a load (an event-loop edge resolves a query
        whose tenant must load off its loop)."""
        with self._lock:
            return key in self._runtimes

    def route(self, query_json: dict) -> tuple[tuple[str, str], str, bool]:
        """The query's tenant key, its variant and whether the variant
        was assigned; raises :class:`UnknownTenant`."""
        with self._lock:
            # one snapshot of the routing tables: tenant add/remove
            # mutates them live, and a query's app->experiment->spec
            # walk must be self-consistent
            by_access_key = dict(self._by_access_key)
            experiments = dict(self._experiments)
            spec_keys = set(self._specs)
        app = query_json.get("app") or query_json.get("appId")
        if app is None:
            ak = query_json.get("accessKey")
            if ak is not None:
                app = by_access_key.get(str(ak))
                if app is None:
                    raise UnknownTenant(f"unknown access key {str(ak)[:8]}…")
        if app is None:
            app, default_variant = self.anchor_key
        else:
            app, default_variant = str(app), None
        exp = experiments.get(app)
        if exp is None:
            raise UnknownTenant(f"unknown app {app!r}")
        variant = query_json.get("variant")
        assigned = False
        if variant is None:
            if default_variant is not None and len(exp.variants()) == 1:
                variant = default_variant
            else:
                variant = exp.assign(str(query_json.get("user", "")))
                assigned = True
        key = (app, str(variant))
        if key not in spec_keys:
            raise UnknownTenant(
                f"unknown variant {variant!r} for app {app!r}"
            )
        return key, str(variant), assigned

    def _release(self, rt: TenantRuntime) -> None:
        with self._lock:
            rt.inflight = max(rt.inflight - 1, 0)

    # -- residency / budget ------------------------------------------------
    def get_runtime(self, key: tuple[str, str]) -> TenantRuntime:
        """The resident runtime for ``key``, loading it lazily (and
        evicting LRU tenants past the budget) on first use."""
        with self._lock:
            rt = self._runtimes.get(key)
            if rt is not None:
                self._tick += 1
                rt.last_used = self._tick
                return rt
            spec = self._specs.get(key)
            if spec is None:
                raise UnknownTenant(f"unknown tenant {key}")
            ev = self._loading.get(key)
            mine = ev is None
            if mine:
                ev = threading.Event()
                self._loading[key] = ev
        if not mine:
            # another query is already loading this tenant: wait for
            # that ONE load instead of duplicating seconds of warmup
            ev.wait(self.load_wait_s)
            with self._lock:
                rt = self._runtimes.get(key)
            if rt is None:
                raise TenantUnavailable(
                    f"tenant {spec.key_str} failed to load"
                )
            return rt
        evicted: list[TenantRuntime] = []
        try:
            if self.loader is None:
                raise TenantUnavailable(
                    f"tenant {spec.key_str} is not resident and no "
                    "loader is configured"
                )
            t0 = time.perf_counter()
            with get_tracer().span("hive.load", {"tenant": spec.key_str}):
                rt = self.loader(spec)
            with self._lock:
                evicted = self._evict_to_fit_locked(
                    rt.resident_bytes, exclude=key
                )
                self._runtimes[key] = rt
                self._tick += 1
                rt.last_used = self._tick
                self.loads += 1
                self._book_residency_locked(rt, "load")
            logger.info(
                "loaded tenant %s (%.1f MB resident) in %.2fs",
                spec.key_str, rt.resident_bytes / 1e6,
                time.perf_counter() - t0,
            )
        except TenantUnavailable:
            raise
        except Exception as e:
            logger.exception("tenant %s load failed", spec.key_str)
            raise TenantUnavailable(
                f"tenant {spec.key_str} load failed: "
                f"{type(e).__name__}: {e}"
            ) from e
        finally:
            with self._lock:
                self._loading.pop(key, None)
            ev.set()
            # close evicted batchers OFF the registry lock (the
            # dispatcher join must not stall other tenants' resolves)
            for old in evicted:
                self._close_runtime(old)
        self._sample_device_memory()
        return rt

    def _book_residency_locked(self, rt: TenantRuntime, kind: str) -> None:
        app, variant = rt.key
        TENANT_LOADS_TOTAL.labels(app=app, variant=variant,
                                  kind=kind).inc()
        rt.m_resident.set(
            float(rt.resident_bytes) if kind == "load" else 0.0
        )
        TENANTS_RESIDENT.child().set(float(len(self._runtimes)))
        TENANT_PLACEMENT_BALANCE.child().set(
            self._placement_balance_locked()
        )

    def _placement_balance_locked(self) -> float:
        """Jain fairness index over resident tenants' accounted bytes:
        (Σb)² / (n·Σb²).  1.0 = every resident tenant holds an equal
        byte share, 1/n = one tenant holds everything, 0.0 = nothing
        resident.  Zero-byte runtimes (e.g. stub models in tests)
        count as perfectly even among themselves."""
        sizes = [float(r.resident_bytes)
                 for r in self._runtimes.values()]
        n = len(sizes)
        if n == 0:
            return 0.0
        total = sum(sizes)
        if total <= 0.0:
            return 1.0
        sq = sum(b * b for b in sizes)
        return (total * total) / (n * sq) if sq > 0.0 else 1.0

    def placement_balance(self) -> float:
        with self._lock:
            return self._placement_balance_locked()

    def _evict_to_fit_locked(self, incoming_bytes: int,
                             exclude) -> list[TenantRuntime]:
        """Under the lock: pop LRU tenants until ``incoming_bytes``
        fits the budget.  Pinned, in-flight, and anchor tenants are
        never candidates; if nothing evictable remains the load
        proceeds OVER budget (loudly) — shedding the query would turn
        a memory policy into an outage."""
        if not self.memory_budget_bytes:
            return []
        evicted: list[TenantRuntime] = []
        while (self._resident_bytes_locked() + incoming_bytes
               > self.memory_budget_bytes):
            candidates = [
                r for k, r in self._runtimes.items()
                if k != exclude and not r.pinned and not r.is_anchor
                and r.inflight == 0
            ]
            if not candidates:
                self.overcommits += 1
                app, variant = exclude
                TENANT_LOADS_TOTAL.labels(
                    app=app, variant=variant, kind="overcommit"
                ).inc()
                logger.warning(
                    "memory budget %.1f MB exceeded with no evictable "
                    "tenant (all pinned or in-flight); loading %s over "
                    "budget", self.memory_budget_bytes / 1e6, exclude,
                )
                break
            victim = min(candidates, key=lambda r: r.last_used)
            self._runtimes.pop(victim.key, None)
            self.evictions += 1
            self._book_residency_locked(victim, "evict")
            evicted.append(victim)
            logger.info("evicted tenant %s (%.1f MB) under budget",
                        victim.key_str, victim.resident_bytes / 1e6)
        if evicted and exclude is not None:
            # evictions that made room for an incoming tenant ARE the
            # registry rebalancing its placement (vs an admin shrink)
            self.rebalances += 1
        return evicted

    def _resident_bytes_locked(self) -> int:
        return sum(r.resident_bytes for r in self._runtimes.values())

    def resident_bytes_total(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    def resident_keys(self) -> list[tuple[str, str]]:
        with self._lock:
            return list(self._runtimes)

    def evict(self, key: tuple[str, str]) -> bool:
        """Explicit eviction (admin/test surface).  Refuses pinned/
        in-flight tenants — same safety rule as budget eviction."""
        with self._lock:
            rt = self._runtimes.get(key)
            if rt is None or rt.pinned or rt.is_anchor or rt.inflight:
                return False
            self._runtimes.pop(key)
            self.evictions += 1
            self._book_residency_locked(rt, "evict")
        self._close_runtime(rt)
        self._sample_device_memory()
        return True

    def set_memory_budget(self, budget_bytes: Optional[float]) -> list:
        """Hot-update the budget; an aggressive shrink evicts down to
        it immediately (in-flight/pinned tenants still exempt).
        Returns the evicted keys."""
        with self._lock:
            self.memory_budget_bytes = int(budget_bytes or 0)
            TENANT_MEMORY_BUDGET.child().set(
                float(self.memory_budget_bytes)
            )
            evicted = self._evict_to_fit_locked(0, exclude=None)
        for rt in evicted:
            self._close_runtime(rt)
        if evicted:
            self._sample_device_memory()
        return [rt.key for rt in evicted]

    def adopt_anchor(self, runtime: TenantRuntime) -> None:
        """Install the serving process's base components as the anchor
        tenant's runtime — one copy of the model serves both the
        default (tenant-less) path and explicit queries for the anchor
        (app, variant).  Always pinned: the anchor is the process's
        raison d'être, not an eviction candidate."""
        runtime.pinned = True
        runtime.is_anchor = True
        with self._lock:
            self._runtimes[self.anchor_key] = runtime
            self._tick += 1
            runtime.last_used = self._tick
            self._book_residency_locked(runtime, "load")

    def _close_runtime(self, rt: TenantRuntime) -> None:
        """Retire an unloaded runtime: close its batcher view and drop
        its references to the components, so nothing the registry or
        the shared batcher holds keeps the tenant's tensors alive (a
        query still holding its snapshot keeps them until it ends)."""
        batcher = rt.batcher
        rt.algorithms = rt.models = rt.serving = rt.batcher = None
        if batcher is not None:
            try:
                batcher.close()
            except Exception:
                logger.exception("closing evicted tenant %s batcher",
                                 rt.key_str)

    def _sample_device_memory(self) -> None:
        """Refresh the per-device memory gauges (``torch.cuda.
        memory_stats``) so the allocator's view tracks loads and
        evictions, not just the sampler's cadence.  Best-effort:
        accounting never fails a query."""
        try:
            from ..obs import xray

            xray.sample_devices_once()
        except Exception:
            pass

    # -- pio-live: per-tenant fold-in -------------------------------------
    def apply_available_deltas(self) -> int:
        """Walk every resident (non-anchor) tenant's delta chain and
        apply pending links in place: the per-tenant half of the
        serving fold-in poll (the anchor rides ``EngineServer``'s own
        chain walk).  One tenant's chain error is recorded on that
        tenant and the walk continues: a fold-in push must not pause
        the rest of the hive."""
        with self._lock:
            runtimes = [r for r in self._runtimes.values()
                        if not r.is_anchor]
        return sum(self.catch_up(rt) for rt in runtimes)

    def catch_up(self, rt: TenantRuntime) -> int:
        """Apply the links of ``rt``'s delta chain past the last one it
        applied; the number applied.  The serving loader calls it on a
        runtime it has just built, so a lazy load (a reload after an
        eviction too) never serves staler than the chain."""
        from ..live.apply import apply_model_delta, model_supports_deltas
        from ..workflow.model_io import load_model_delta_chain, model_key

        if rt.models is None:
            return 0  # evicted since the caller looked
        n_applied = 0
        try:
            base_dir = rt.ctx.storage.model_data_dir() / rt.instance_id
            names = [n for n, _ in rt.engine_params.algorithms]
            for ax, (name, model) in enumerate(zip(names, rt.models)):
                if not model_supports_deltas(model):
                    continue
                key = model_key(rt.instance_id, ax, name)
                with self._lock:
                    after = rt.foldin_applied_seq.get(key, 0)
                chain, err = load_model_delta_chain(base_dir, key,
                                                    after_seq=after)
                if err:
                    with self._lock:
                        rt.last_foldin_error = err
                for d in chain:
                    t0 = time.perf_counter()
                    with self._lock:
                        if rt.foldin_applied_seq.get(key, 0) >= d.seq:
                            continue  # a concurrent walk applied it
                        apply_model_delta(model, d)
                        rt.foldin_applied_seq[key] = d.seq
                        rt.foldin_deltas_applied += 1
                        rt.model_advanced_mono = time.monotonic()
                        rt.last_foldin_error = None
                    FOLDIN_APPLIES_TOTAL.labels(result="ok").inc()
                    get_tracer().record(
                        "live.apply", time.perf_counter() - t0,
                        attrs={"tenant": rt.key_str, "seq": d.seq},
                    )
                    n_applied += 1
        except Exception as e:
            FOLDIN_APPLIES_TOTAL.labels(result="error").inc()
            with self._lock:
                rt.last_foldin_error = f"{type(e).__name__}: {e}"
            logger.exception(
                "fold-in apply failed for tenant %s; it keeps serving "
                "its stale model", rt.key_str,
            )
        return n_applied

    # -- online eval -------------------------------------------------------
    def refresh_online_eval(self, event_store) -> dict:
        """Fold fresh conversion events into the per-variant outcome
        table (see :mod:`.online_eval`); returns the snapshot."""
        app_ids = {}
        with self._lock:
            for s in self._specs.values():
                if s.app_id is not None:
                    app_ids[s.app] = s.app_id
        return self.online.refresh(event_store, app_ids)

    # -- autopilot (pio-pilot) ---------------------------------------------
    def enable_autopilot(self, config=None, apply_weights=None,
                         manifest_id=None):
        """Attach a self-driving experiment controller (see
        :mod:`.autopilot`).  ``config`` is an :class:`AutopilotConfig`
        or a camelCase knob dict (the tenants.json ``"autopilot"``
        block); ``apply_weights`` overrides how ramp steps land
        (default: in-process ``set_weights`` — the serving edge or a
        smoke passes the real HTTP broadcast)."""
        from .autopilot import AutoPilot, AutopilotConfig, set_autopilot

        if config is not None and not isinstance(config, AutopilotConfig):
            config = AutopilotConfig.from_doc(dict(config))
        self.autopilot = AutoPilot(
            self, config=config, apply_weights=apply_weights,
            manifest_id=manifest_id,
        )
        set_autopilot(self.autopilot)
        return self.autopilot

    def autopilot_tick(self) -> Optional[dict]:
        """One controller pass, or ``None`` when no autopilot is
        attached (the serving loop calls this unconditionally)."""
        pilot = self.autopilot
        if pilot is None:
            return None
        return pilot.tick()

    # -- views -------------------------------------------------------------
    def summary(self) -> dict:
        """The small status-JSON block."""
        with self._lock:
            return {
                "tenants": len(self._specs),
                "resident": len(self._runtimes),
                "residentBytes": self._resident_bytes_locked(),
                "memoryBudgetBytes": self.memory_budget_bytes,
                "loads": self.loads,
                "evictions": self.evictions,
                "overcommits": self.overcommits,
                "rebalances": self.rebalances,
                "placementBalance": self._placement_balance_locked(),
            }

    def debug_payload(self) -> dict:
        """The full ``GET /debug/tenants`` document."""
        with self._lock:
            resident = {
                rt.key_str: rt.snapshot()
                for rt in self._runtimes.values()
            }
            specs = [
                {
                    "app": s.app, "variant": s.variant,
                    "weight": s.weight, "pinned": s.pinned,
                    "quotaQps": s.quota_qps,
                    "resident": s.key in self._runtimes,
                }
                for s in self._specs.values()
            ]
            experiments = dict(self._experiments)
        out = {
            **self.summary(),
            "anchor": "/".join(self.anchor_key),
            "specs": specs,
            "resident_tenants": resident,
            "experiments": {
                app: exp.snapshot()
                for app, exp in experiments.items()
            },
            "onlineEval": self.online.snapshot(),
            "autopilot": (
                self.autopilot.manifest_id
                if self.autopilot is not None else None
            ),
        }
        try:
            from ..obs import xray

            out["deviceMemory"] = xray.sample_devices_once()
        except Exception:
            pass
        return out

    def close(self) -> None:
        with self._lock:
            runtimes = list(self._runtimes.values())
            self._runtimes.clear()
        for rt in runtimes:
            if not rt.is_anchor:  # the server owns the anchor batcher
                self._close_runtime(rt)
        self.online.close()
        pilot = self.autopilot
        if pilot is not None:
            from .autopilot import set_autopilot

            set_autopilot(None)
            pilot.close()


# -- tenants.json manifest ---------------------------------------------------


def load_tenant_manifest(path) -> tuple[list[TenantSpec], dict]:
    """Parse a ``deploy --multi`` tenants manifest::

        {
          "memoryBudgetBytes": 2e9,          // optional, 0/absent = off
          "experimentSalt": "exp-2026w31",   // optional
          "defaultQuotaQps": 500,            // optional per-tenant default
          "evalIntervalSec": 5,              // optional online-eval cadence
          "tenants": [
            {"app": "shop", "variant": "control", "engineJson": "a/engine.json",
             "weight": 0.5, "pinned": true, "quotaQps": 200,
             "engineInstanceId": null, "accessKey": null}
          ]
        }

    Returns ``(specs, options)``.  ``engineJson`` strings pass through
    VERBATIM: the string doubles as the engine-variant key the trained
    instance was registered under (`run_train(engine_variant=...)`),
    so it must equal what was passed to ``pio-tpu train`` — exactly
    the single-tenant ``--engine-json`` contract.  Relative paths
    therefore resolve against the deploy cwd, like every other CLI
    engine.json.  A tenant may instead carry ``"engine": "<name>"``
    naming a pio-forge REGISTERED engine (``pio-tpu engines list``);
    its instance resolves under the ``engine:<name>`` variant key
    (`train --engine <name>`)."""
    p = Path(path)
    doc = json.loads(p.read_text())
    tenants = doc.get("tenants")
    if not tenants:
        raise ValueError(f"{p}: manifest has no tenants")
    specs = []
    for t in tenants:
        ej = t.get("engineJson")
        specs.append(TenantSpec(
            app=t.get("app", ""),
            variant=t.get("variant", "default"),
            engine_json=ej,
            engine_name=t.get("engine"),
            instance_id=t.get("engineInstanceId"),
            access_key=t.get("accessKey"),
            weight=float(t.get("weight", 1.0)),
            pinned=bool(t.get("pinned", False)),
            quota_qps=t.get("quotaQps"),
            quota_burst=t.get("quotaBurst"),
        ))
    options = {
        "memory_budget_bytes": doc.get("memoryBudgetBytes"),
        "salt": doc.get("experimentSalt", "pio-hive"),
        "default_quota_qps": doc.get("defaultQuotaQps"),
        "eval_interval_s": float(doc.get("evalIntervalSec", 5.0)),
        # pio-pilot: {"autopilot": {"alpha": .., "minLift": ..}} (any
        # knob optional, presence alone enables the controller)
        "autopilot": doc.get("autopilot"),
    }
    return specs, options
