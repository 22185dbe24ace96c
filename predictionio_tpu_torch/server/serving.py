"""Engine deployment server: answers ``/queries.json`` with predictions.

Port of ``predictionio_tpu/server/serving.py`` on its ``"threads"`` edge
(the stdlib threading HTTP server), a re-expression of the reference's
`workflow/CreateServer.scala` (`ServerActor` routes `:433-612`,
`MasterActor` lifecycle `:255-377`).  Routes:

* ``GET  /``             — status JSON: engine info, request count, latency
  (``avgServingSec``/``lastServingSec`` parity, `CreateServer.scala:552-559`)
* ``POST /queries.json`` — score a query (the hot path); concurrent
  queries are coalesced into one batched device call by
  :class:`~predictionio_tpu_torch.server.microbatch.MicroBatcher` when
  every algorithm has a real ``batch_predict`` (``microbatch="auto"``)
* ``GET  /reload``       — hot-swap to the latest COMPLETED engine instance
* ``POST /stop``         — graceful shutdown

Query/result JSON mapping: the engine's first algorithm may declare
``query_class`` (with ``from_json``) and results may expose ``to_json``.
The server's device is its context's, which defaults to the card.

Not ported yet, and refused where a caller asks for them: the
``"eventloop"`` edge, feedback-loop event injection, remote error logs,
fold-in deltas, tenancy and experiments, the HTML status page and the
observability mounts.
"""

from __future__ import annotations

import collections
import json
import logging
import sys
import threading
import time
import urllib.parse
from dataclasses import asdict, is_dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..controller.base import Algorithm, WorkflowContext
from ..controller.engine import Engine, EngineParams
from ..resilience.policy import Deadline, DeadlineExceeded
from ..workflow.train import prepare_deploy_components
from .http_base import DEFAULT_MAX_CONNECTIONS, HTTPServerBase, JsonRequestHandler
from .microbatch import AdmissionRejected, MicroBatcher

logger = logging.getLogger(__name__)

__all__ = ["EngineServer", "ServerConfig"]

# recent query latencies kept for the status percentiles
_LATENCY_WINDOW = 4096


class ServerConfig:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 microbatch: str = "auto", microbatch_max: int = 64,
                 query_timeout_s: Optional[float] = None,
                 edge: str = "threads",
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 feedback: bool = False):
        self.host = host
        self.port = port
        if edge == "eventloop":
            raise NotImplementedError(
                "the eventloop edge (server/eventloop.py) is not ported to "
                "predictionio_tpu_torch yet (ROADMAP Queue 1); use "
                "edge='threads'"
            )
        if edge != "threads":
            raise ValueError(f"edge must be eventloop|threads, got {edge!r}")
        self.edge = edge
        # concurrent-connection cap: connection attempts past it are
        # answered a structured 503 and closed
        self.max_connections = max_connections
        if feedback:
            raise NotImplementedError(
                "feedback-loop event injection is not ported to "
                "predictionio_tpu_torch yet (ROADMAP Queue 1)"
            )
        # concurrent-query coalescing (server/microbatch.py): "auto"
        # batches when every algorithm provides a real batch_predict,
        # "on" forces it, "off" keeps per-request device calls
        if microbatch not in ("auto", "on", "off"):
            raise ValueError(
                f"microbatch must be auto|on|off, got {microbatch!r}"
            )
        self.microbatch = microbatch
        self.microbatch_max = microbatch_max
        # per-request time budget (None = unbounded); expiry answers a
        # structured 503 instead of queueing device work for a client
        # that already gave up
        self.query_timeout_s = query_timeout_s


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


class EngineServer(HTTPServerBase):
    """One deployed engine instance behind an HTTP server."""

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
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.ctx = ctx or WorkflowContext(mode="Serving")
        self.config = config or ServerConfig()
        self.instance_id = instance_id
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.query_decoder = query_decoder or _default_query_decoder(
            engine, engine_params
        )
        self._lock = threading.RLock()
        self.last_reload_error: Optional[str] = None
        self._load(instance_id)
        # serving stats (CreateServer.scala:396-398)
        self.request_count = 0
        self.last_serving_sec = 0.0
        self.start_time = time.time()  # wall clock: a TIMESTAMP, not a span
        self._latency_sum = 0.0
        self._latencies: collections.deque = collections.deque(
            maxlen=_LATENCY_WINDOW
        )

    # -- lifecycle --------------------------------------------------------
    def _load(self, instance_id: str) -> None:
        """Load an instance's components and swap them in atomically; a
        failed (re)load leaves the previous components serving."""
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
            self.engine_params = engine_params
            self.models = models
            self.algorithms = algorithms
            self.serving = serving
            self.instance_id = instance_id
            self.batcher = batcher

    def _make_batcher(self, algorithms, models) -> Optional[MicroBatcher]:
        """The query micro-batcher for this (algorithms, models) snapshot,
        or None when batching cannot help: ``"auto"`` batches only when
        every algorithm overrides ``batch_predict`` (the base class just
        maps ``predict``)."""
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

        return MicroBatcher(
            batch_fn, max_batch=self.config.microbatch_max, pad_batches=True,
        )

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
        try:
            self._load(latest.id)
        except Exception as e:
            with self._lock:
                self.last_reload_error = f"{type(e).__name__}: {e}"
            raise
        with self._lock:
            self.last_reload_error = None
        return latest.id

    # -- query path -------------------------------------------------------
    def predict_json(self, query_json: dict,
                     timeout_s: Optional[float] = None) -> Any:
        """Decode, predict (through the batcher when there is one),
        serve and encode one query; the blocking path of the threads
        edge and of direct library callers."""
        t0 = time.perf_counter()
        budget = (timeout_s if timeout_s is not None
                  else self.config.query_timeout_s)
        deadline = Deadline.after(budget) if budget is not None else None
        query = self.query_decoder(query_json)
        with self._lock:
            algorithms, models = self.algorithms, self.models
            serving, batcher = self.serving, self.batcher
        if deadline is not None:
            if batcher is not None:
                batcher.check_admission(deadline)
            deadline.check("query device dispatch")
        if batcher is not None:
            predictions = batcher.submit(query, deadline=deadline)
        else:
            predictions = [
                algo.predict(model, query)
                for algo, model in zip(algorithms, models)
            ]
        if deadline is not None:
            deadline.check("query serving")
        out = _result_to_json(serving.serve(query, predictions))
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.last_serving_sec = dt
            self._latency_sum += dt
            self._latencies.append(dt)
        return out

    def latency_stats(self) -> dict:
        """Average over every query served, percentiles over the most
        recent ones (up to 4,096)."""
        with self._lock:
            n, total = self.request_count, self._latency_sum
            recent = np.fromiter(self._latencies, dtype=np.float64)
        if n == 0:
            return {"count": 0, "avg": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        p50, p95, p99 = np.percentile(recent, [50, 95, 99])
        return {"count": n, "avg": total / n, "p50": float(p50),
                "p95": float(p95), "p99": float(p99)}

    def status_json(self) -> dict:
        with self._lock:
            instance_id = self.instance_id
            request_count = self.request_count
            last_serving_sec = self.last_serving_sec
            batcher = self.batcher
            last_reload_error = self.last_reload_error
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
            },
        }
        if batcher is not None:
            out["microbatch"] = batcher.stats()
        return out

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
        class Handler(JsonRequestHandler):
            server_logger = logger

            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    self._reply(200, server.status_json())
                elif path == "/reload":
                    try:
                        self._reply(200, {"reloaded": server.reload()})
                    except LookupError as e:
                        self._reply(404, {"message": str(e)})
                    except Exception as e:
                        logger.exception("reload failed")
                        self._reply(500, {"message": f"reload failed: {e}"})
                else:
                    self._reply(404, {"message": "not found"})

            def do_POST(self):
                raw = self._body() or b"{}"
                path = urllib.parse.urlparse(self.path).path
                if path == "/queries.json":
                    self._post_query(raw)
                elif path == "/stop":
                    self._reply(200, {"message": "stopping"})
                    threading.Thread(target=server.stop, daemon=True).start()
                else:
                    self._reply(404, {"message": "not found"})

            def _post_query(self, raw: bytes) -> None:
                try:
                    query_json = json.loads(raw.decode() or "{}")
                except (UnicodeDecodeError, json.JSONDecodeError) as e:
                    self._reply(400, {"message": f"invalid JSON: {e}"})
                    return
                # optional per-request budget: /queries.json?timeout=0.5
                timeout_s = None
                tv = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query
                ).get("timeout")
                if tv:
                    try:
                        timeout_s = float(tv[0])
                    except ValueError:
                        self._reply(
                            400, {"message": f"bad timeout: {tv[0]!r}"}
                        )
                        return
                try:
                    self._reply(200, server.predict_json(
                        query_json, timeout_s=timeout_s))
                except AdmissionRejected as e:
                    self.extra_headers = [("Retry-After", "1")]
                    self._reply(503, {"message": str(e),
                                      "error": "AdmissionRejected"})
                except DeadlineExceeded as e:
                    self.extra_headers = [("Retry-After", "1")]
                    self._reply(503, {"message": str(e),
                                      "error": "DeadlineExceeded"})
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"message": f"bad query: {e}"})
                except Exception as e:
                    logger.exception("query failed")
                    self._reply(500, {"message": str(e)})
                finally:
                    self.extra_headers = []

        return Handler
