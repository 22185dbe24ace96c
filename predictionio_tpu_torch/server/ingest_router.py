"""Fault-isolated multi-process ingest edge.

Port of ``predictionio_tpu/server/ingest_router.py``.
``eventserver --workers N`` boots N shard-owner WORKER processes (each
a full `EventServer`, ``python -m predictionio_tpu_torch eventserver``,
with its own interpreter, its own ingest WAL and a fixed subset of the
sharded store's entity-hash shards) and ONE router in front.  Writes
cannot fail over: an event write belongs to exactly one shard owner
(that process holds the shard's sqlite writer lock and WAL), so when
the owner is down the honest answer is a structured
``503 {"error": "ShardUnavailable", "shard": I}`` + ``Retry-After`` on
that shard's entities — and 2xx everywhere else.  One dead worker is a
partial outage of 1/N of the keyspace, never a fleet outage and never
silent loss (acknowledged events live in the dead owner's WAL and
replay when its replacement boots).

* **Routing**: the entity-hash routing table is the STORE's own
  ``crc32(entity_type ++ entity_id) % n_shards`` (one definition,
  `sharded_events._shard_ix`), striped over workers
  (``shard % n_workers``).  Single-event POSTs route whole; batch
  POSTs split per owner and re-merge per-event statuses positionally.
  Entity-scoped reads go to the owner (whose WAL barrier gives
  read-your-writes); keyspace-wide reads round-robin healthy workers
  (sqlite files take cross-process readers freely — ownership gates
  writers).
* **Health + respawn**: the router's health loop probes each worker's
  ``GET /``, scrapes its ``/metrics``, maintains
  ``pio_ingest_worker_up{worker}`` and feeds the
  `router.ReplicaSupervisor`, so a SIGKILLed
  worker respawns (same WAL dir → boot replay folds its acknowledged
  backlog into sqlite before the port announce).
* **Federation**: ``GET /metrics`` merges worker snapshots via
  ``merge_states(gauge_label="worker")`` (counters and histograms sum
  exactly, gauges gain ``{worker}``); ``GET /stats.json`` merges the
  workers' payloads via `stats.merge_stats_payloads`.  Both keep a dead
  worker's last-good snapshot standing, so fleet counters are monotone
  through a death.
* **Tracing**: every write carries an ``X-PIO-Trace`` id (the client's,
  or one minted here) to its owner and back, and each routed write is
  offered to the process flight recorder under its owner and shard.

The router rides the event-loop edge: the loop thread parses and
routes; every blocking upstream hop runs on a bounded pool.

"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Optional

from ..storage.sharded_events import _shard_ix
from .eventloop import EventLoopHTTPServer, callback_scope
from ..obs import (
    INGEST_FORWARD_SECONDS,
    INGEST_SHARD_UNAVAILABLE_TOTAL,
    INGEST_WORKER_UP,
    TRACE_HEADER,
    get_flight_recorder,
    get_registry,
    metrics_enabled,
    new_trace_id,
    scope,
)
from ..obs.registry import merge_states, render_state
from .http_base import (
    PROMETHEUS_CTYPE,
    HTTPServerBase,
    observability_response,
)
from .router import (
    Replica,
    ReplicaSupervisor,
    spawn_port_process,
    wait_for_port_file,
)
from .stats import merge_stats_payloads
from .webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorError,
    to_event,
)

__all__ = [
    "IngestRouterConfig",
    "IngestRouterServer",
    "IngestWorker",
    "boot_ingest_fleet",
    "shards_for_worker",
    "spawn_ingest_worker",
]

logger = logging.getLogger(__name__)

# seconds between health sweeps, and each probe's own timeout
_HEALTH_INTERVAL_S = 1.0
_HEALTH_TIMEOUT_S = 2.0
# one forwarded request's timeout
_FORWARD_TIMEOUT_S = 30.0
# threads for the blocking upstream hops
_POOL_THREADS = 16
# the Retry-After a dead shard answers with: sized for a supervisor
# respawn (a few seconds of boot + WAL replay), not a lock blip
_RETRY_AFTER_S = 2


def shards_for_worker(index: int, n_workers: int,
                      n_shards: int) -> list[int]:
    """Striped ownership: worker i owns every shard ≡ i (mod N).  With
    the crc32 entity hash distributing entities uniformly, striping
    keeps per-worker load within noise of even for any N ≤ shards."""
    return [s for s in range(n_shards) if s % n_workers == index]


class IngestWorker(Replica):
    """One shard-owner worker, as the router sees it: the pooled-
    connection `Replica` surface plus its owned-shard set and the
    last-good ``/stats.json`` payload (per access key) that keeps the
    federated stats monotone through its death."""

    def __init__(self, name: str, host: str, port: int,
                 shards: list[int], index: int):
        super().__init__(name, host, port)
        self.shards = list(shards)
        self.index = index
        # accessKey-scoped query string -> last good /stats.json body;
        # rebound whole per fetch, never mutated
        self.last_stats: dict[str, dict] = {}
        self._m_worker_up = INGEST_WORKER_UP.labels(worker=name)
        self._m_worker_up.set(1.0)

    def mark_down(self, err: str) -> None:
        super().mark_down(err)
        self._m_worker_up.set(0.0)

    def mark_up(self) -> None:
        super().mark_up()
        self._m_worker_up.set(1.0)


class IngestRouterConfig:
    def __init__(self, host: str = "127.0.0.1", port: int = 7070,
                 n_shards: int = 4, max_connections: int = 1024):
        self.host = host
        self.port = port
        self.n_shards = n_shards
        self.max_connections = max_connections


class IngestRouterServer(HTTPServerBase):
    """The ingest fleet's front door; see module docstring."""

    server_name = "ingest-router"

    def __init__(self, workers: list[IngestWorker],
                 config: Optional[IngestRouterConfig] = None,
                 supervisor: Optional[ReplicaSupervisor] = None):
        if not workers:
            raise ValueError("ingest router needs at least one worker")
        self.workers = workers
        self.config = config or IngestRouterConfig()
        self.supervisor = supervisor
        # shard -> owning worker, built once: ownership is fixed for
        # the fleet's lifetime (respawns keep their index)
        self.shard_owner: dict[int, IngestWorker] = {}
        for w in workers:
            for s in w.shards:
                if s in self.shard_owner:
                    raise ValueError(
                        f"shard {s} claimed by both "
                        f"{self.shard_owner[s].name} and {w.name}"
                    )
                self.shard_owner[s] = w
        missing = [s for s in range(self.config.n_shards)
                   if s not in self.shard_owner]
        if missing:
            raise ValueError(f"shards {missing} have no owner")
        self._by_index = {w.index: w for w in workers}
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._lock = threading.Lock()  # the round-robin cursor and counters
        self._rr = 0
        self._stop_event = threading.Event()
        self.start_time = time.time()
        self.request_count = 0
        self.shard_unavailable = 0
        self._health_thread: Optional[threading.Thread] = None
        self._m_forward = INGEST_FORWARD_SECONDS.child()
        # the router has no serve.query traffic, so the process flight
        # recorder is the ingest worst-N view (served by /debug/flight);
        # offers carry the owning worker and shard
        self.flight = get_flight_recorder()

    # -- lifecycle ---------------------------------------------------------
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

    def _build_httpd(self):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=_POOL_THREADS,
                thread_name_prefix="ingest-fwd",
                initializer=scope.register_thread_role,
                initargs=("ingest_worker",),
            )
        scope.ensure_started()
        if self._health_thread is None:
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="ingest-router-health",
            )
            self._health_thread.start()
        return EventLoopHTTPServer(
            (self.host, self.port), self._el_handle,
            max_connections=self.config.max_connections,
            name="ingest-router",
        )

    def stop(self) -> None:
        super().stop()
        self._stop_event.set()
        if self._health_thread is not None:
            self._health_thread.join(
                timeout=_HEALTH_INTERVAL_S
                + 2 * _HEALTH_TIMEOUT_S * len(self.workers)
            )
            self._health_thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # -- health ------------------------------------------------------------
    def check_worker(self, w: IngestWorker) -> bool:
        try:
            status, data, _ = w.request(
                "GET", "/", None,
                timeout_s=_HEALTH_TIMEOUT_S,
            )
            if status != 200:
                w.mark_down(f"status {status}")
                return False
            json.loads(data.decode())
            w.mark_up()
            return True
        except Exception as e:
            w.mark_down(f"{type(e).__name__}: {e}")
            return False

    def _health_loop(self) -> None:
        scope.register_thread_role("health_loop")
        while not self._stop_event.wait(_HEALTH_INTERVAL_S):
            for w in self.workers:
                self.check_worker(w)
            for w in self.workers:
                w.scrape(_HEALTH_TIMEOUT_S)
            if self.supervisor is not None:
                try:
                    self.supervisor.tick(self.workers)
                except Exception:
                    logger.exception("worker supervisor tick failed")

    # -- routing -----------------------------------------------------------
    def owner_of(self, entity_type: str, entity_id: str) -> IngestWorker:
        six = _shard_ix(entity_type, entity_id, self.config.n_shards)
        return self.shard_owner[six]

    def _any_healthy(self) -> Optional[IngestWorker]:
        with self._lock:
            self._rr += 1
            start = self._rr
        n = len(self.workers)
        for i in range(n):
            w = self.workers[(start + i) % n]
            if w.healthy:
                return w
        return None

    def _unavailable_payload(self, w: IngestWorker, six: int) -> dict:
        return {
            "message": (
                f"shard {six} unavailable: owner {w.name} is down "
                f"({w.last_error or 'no heartbeat'})"
            ),
            "error": "ShardUnavailable",
            "shard": six,
        }

    def _retry_hdr(self) -> list[tuple[str, str]]:
        return [("Retry-After", str(_RETRY_AFTER_S))]

    def _book_unavailable(self, six: int, n: int = 1) -> None:
        with self._lock:
            self.shard_unavailable += n
        INGEST_SHARD_UNAVAILABLE_TOTAL.labels(shard=str(six)).inc(n)

    def _forward(self, w: IngestWorker, method: str, path_qs: str,
                 body: Optional[bytes],
                 trace_id: Optional[str] = None) -> tuple[int, bytes, str]:
        """One worker round trip; transport failure marks the worker
        down and re-raises (the caller answers ShardUnavailable — a
        write's owner is the ONLY process holding its shards, so there
        is no second candidate to try)."""
        t0 = time.perf_counter()
        try:
            out = w.request(method, path_qs, body,
                            timeout_s=_FORWARD_TIMEOUT_S, trace_id=trace_id)
        except Exception as e:
            w.errors += 1
            w.mark_down(f"{type(e).__name__}: {e}")
            raise
        if not w.healthy:
            w.mark_up()
        w.forwarded += 1
        self._m_forward.observe(time.perf_counter() - t0)
        return out

    def _answer_unavailable(self, respond, w: IngestWorker,
                            six: int) -> None:
        self._book_unavailable(six)
        self._respond_quiet(
            respond, 503, self._unavailable_payload(w, six),
            extra_headers=self._retry_hdr(),
        )

    # -- write path (pool side) -------------------------------------------
    def _offer_flight(self, trace_id: Optional[str], t0: float,
                      **attrs) -> None:
        """Offer one finished ingest request to the worst-N recorder,
        attributed to its shard owner."""
        self.flight.offer(
            trace_id, time.perf_counter() - t0, name="ingest.request",
            attrs={k: v for k, v in attrs.items() if v is not None},
        )

    def _post_event(self, path_qs: str, body: bytes, respond,
                    trace_id: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        try:
            payload = json.loads(body.decode())
            et = str(payload["entityType"])
            ei = str(payload["entityId"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            self._respond_quiet(
                respond, 400, {"message": f"invalid event body: {e}"}
            )
            return
        six = _shard_ix(et, ei, self.config.n_shards)
        w = self.shard_owner[six]
        if not w.healthy:
            self._answer_unavailable(respond, w, six)
            self._offer_flight(trace_id, t0, worker=w.name, shard=six,
                               status=503, outcome="shard_unavailable")
            return
        try:
            status, data, ctype = self._forward(w, "POST", path_qs, body,
                                                trace_id=trace_id)
        except Exception:
            self._answer_unavailable(respond, w, six)
            self._offer_flight(trace_id, t0, worker=w.name, shard=six,
                               status=503, outcome="forward_error")
            return
        self._respond_quiet(
            respond, status, data, ctype=ctype,
            extra_headers=[(TRACE_HEADER, trace_id)] if trace_id else (),
        )
        self._offer_flight(trace_id, t0, worker=w.name, shard=six,
                           status=status, events=1)

    def _post_batch(self, path_qs: str, body: bytes, respond,
                    trace_id: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        try:
            items = json.loads(body.decode())
            if not isinstance(items, list):
                raise ValueError("batch body must be a JSON array")
        except (ValueError, UnicodeDecodeError) as e:
            self._respond_quiet(respond, 400, {"message": str(e)})
            return
        if len(items) > 50:
            self._respond_quiet(respond, 400, {
                "message": "batch limited to 50 events; use "
                           "`pio-tpu import` for bulk loads",
            })
            return
        # split by owner, preserving positions; malformed entries get
        # their 400 here (the worker would also 400 them, but a
        # routable batch must not be blocked by an unroutable entry)
        results: list[Optional[dict]] = [None] * len(items)
        shard_of: dict[int, int] = {}     # position -> shard
        groups: dict[int, list[int]] = {}  # worker index -> positions
        for k, item in enumerate(items):
            try:
                et = str(item["entityType"])
                ei = str(item["entityId"])
            except (TypeError, KeyError):
                results[k] = {
                    "status": 400,
                    "message": "event needs entityType and entityId",
                }
                continue
            six = shard_of[k] = _shard_ix(et, ei, self.config.n_shards)
            groups.setdefault(self.shard_owner[six].index, []).append(k)
        qs = urllib.parse.urlparse(path_qs).query
        suffix = f"?{qs}" if qs else ""
        any_down = False
        for windex, positions in sorted(groups.items()):
            w = self._by_index[windex]
            sub = [items[p] for p in positions]
            outcome = None
            if w.healthy:
                try:
                    status, data, _ = self._forward(
                        w, "POST", f"/batch/events.json{suffix}",
                        json.dumps(sub).encode(), trace_id=trace_id,
                    )
                    if status == 200:
                        outcome = json.loads(data.decode())
                    else:
                        # a whole-batch rejection (401 bad key, 400)
                        # applies to each event of the subset
                        msg = {}
                        try:
                            msg = json.loads(data.decode())
                        except ValueError:
                            pass
                        outcome = [{
                            "status": status,
                            "message": msg.get("message", ""),
                        }] * len(sub)
                except Exception:
                    outcome = None
            if outcome is None:
                any_down = True
                for p in positions:
                    self._book_unavailable(shard_of[p])
                    results[p] = dict(
                        self._unavailable_payload(w, shard_of[p]),
                        status=503,
                    )
                continue
            for p, r in zip(positions, outcome):
                results[p] = r
        hdrs = self._retry_hdr() if any_down else []
        if trace_id:
            hdrs = hdrs + [(TRACE_HEADER, trace_id)]
        self._respond_quiet(respond, 200, results, extra_headers=hdrs)
        self._offer_flight(
            trace_id, t0, events=len(items),
            workers=sorted(self._by_index[i].name for i in groups),
            status=200, anyDown=any_down or None,
        )

    def _post_webhook(self, path_qs: str, path: str, body: bytes,
                      respond, trace_id: Optional[str] = None) -> None:
        """Webhook ingestion under sharding: the CONNECTOR decides the
        entity, so the router must run it to learn the owner.  Convert
        here, then forward the derived event as a plain POST — the
        worker re-validates and authenticates as usual."""
        name = path[len("/webhooks/"):]
        try:
            if name.endswith(".json"):
                connector = JSON_CONNECTORS.get(name[: -len(".json")])
                data = json.loads(body.decode() or "{}")
            elif name.endswith(".form"):
                connector = FORM_CONNECTORS.get(name[: -len(".form")])
                form = urllib.parse.parse_qs(
                    body.decode(), keep_blank_values=True
                )
                data = {k: v[0] for k, v in form.items()}
            else:
                connector = None
            if connector is None:
                self._respond_quiet(
                    respond, 404, {"message": f"webhook {name} not found"}
                )
                return
            event = to_event(connector, data)
        except (ConnectorError, ValueError, UnicodeDecodeError) as e:
            self._respond_quiet(respond, 400, {"message": str(e)})
            return
        qs = urllib.parse.urlparse(path_qs).query
        suffix = f"?{qs}" if qs else ""
        self._post_event(
            f"/events.json{suffix}",
            json.dumps(event.to_json()).encode(), respond,
            trace_id=trace_id,
        )

    # -- read path (pool side) --------------------------------------------
    def _forward_read(self, method: str, path_qs: str, respond) -> None:
        """Reads prefer the entity's owner (its WAL barrier makes a
        just-acked write visible); keyspace-wide reads take any healthy
        worker.  Cross-owner read-your-writes is bounded by the owners'
        commit interval (~20ms), the documented federation caveat."""
        params = urllib.parse.parse_qs(urllib.parse.urlparse(path_qs).query)
        w = None
        et, ei = params.get("entityType"), params.get("entityId")
        if et and ei:
            six = _shard_ix(et[0], ei[0], self.config.n_shards)
            w = self.shard_owner[six]
            if not w.healthy:
                self._answer_unavailable(respond, w, six)
                return
        if w is None:
            w = self._any_healthy()
        if w is None:
            self._respond_quiet(
                respond, 503,
                {"message": "no ingest worker available",
                 "error": "NoWorkerAvailable"},
                extra_headers=self._retry_hdr(),
            )
            return
        try:
            status, data, ctype = self._forward(w, method, path_qs, None)
        except Exception as e:
            self._respond_quiet(
                respond, 503,
                {"message": f"worker {w.name} died mid-read: {e}",
                 "error": "NoWorkerAvailable"},
                extra_headers=self._retry_hdr(),
            )
            return
        self._respond_quiet(respond, status, data, ctype=ctype)

    # -- federation (pool side) -------------------------------------------
    def _get_stats(self, path_qs: str, respond) -> None:
        """Federated ``/stats.json``: every worker's payload merged;
        a dead worker contributes its last good payload so the merged
        counters never step backward (monotone through a death)."""
        cache_key = urllib.parse.urlparse(path_qs).query
        payloads = []
        first_err: Optional[tuple[int, bytes, str]] = None
        for w in self.workers:
            got = None
            if w.healthy:
                try:
                    status, data, ctype = self._forward(
                        w, "GET", path_qs, None
                    )
                    if status == 200:
                        got = json.loads(data.decode())
                    elif first_err is None:
                        # auth/4xx propagates verbatim — a bad access
                        # key is the client's problem, not the fleet's
                        first_err = (status, data, ctype)
                except Exception:
                    got = None
            if got is not None:
                w.last_stats[cache_key] = got
                payloads.append(got)
            elif cache_key in w.last_stats:
                payloads.append(w.last_stats[cache_key])
        if not payloads:
            if first_err is not None:
                status, data, ctype = first_err
                self._respond_quiet(respond, status, data, ctype=ctype)
            else:
                self._respond_quiet(
                    respond, 503,
                    {"message": "no ingest worker answered /stats.json",
                     "error": "NoWorkerAvailable"},
                    extra_headers=self._retry_hdr(),
                )
            return
        merged = merge_stats_payloads(payloads)
        merged["workers"] = {
            "total": len(self.workers),
            "healthy": sum(w.healthy for w in self.workers),
            "reporting": len(payloads),
        }
        self._respond_quiet(respond, 200, merged)

    def render_fleet_metrics(self) -> bytes:
        """``GET /metrics``: router-local state merged with every
        worker's last scraped snapshot, gauges labeled ``{worker}`` —
        one scrape answers for the whole ingest fleet, and a dead
        worker's last-good snapshot keeps the merged counters
        monotone."""
        tagged = [("router", get_registry().dump_state())]
        for w in self.workers:
            if w.metrics_state is not None:
                tagged.append((w.name, w.metrics_state))
        try:
            return render_state(
                merge_states(tagged, gauge_label="worker")
            ).encode()
        except ValueError as e:
            logger.warning(
                "ingest fleet metrics merge failed (%s); serving the "
                "router-local exposition", e,
            )
            return get_registry().render_prometheus().encode()

    # -- status ------------------------------------------------------------
    def status_json(self) -> dict:
        out = {
            "status": "alive",
            "role": "ingest-router",
            "nShards": self.config.n_shards,
            "workers": [
                dict(w.snapshot(), shards=w.shards, index=w.index)
                for w in self.workers
            ],
            "healthyWorkers": sum(w.healthy for w in self.workers),
            "shardOwners": {
                str(s): w.name
                for s, w in sorted(self.shard_owner.items())
            },
            "requestCount": self.request_count,
            "shardUnavailable": self.shard_unavailable,
            "startTime": self.start_time,
        }
        fs = self.flight.summary()
        out["flight"] = {k: fs[k]
                         for k in ("capacity", "offers", "admissions")}
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.summary()
        return out

    # -- http --------------------------------------------------------------
    @staticmethod
    def _respond_quiet(respond, code, payload, ctype="application/json",
                       extra_headers=()) -> None:
        try:
            respond(code, payload, ctype=ctype,
                    extra_headers=list(extra_headers))
        except RuntimeError:
            pass  # client hung up first

    def _submit(self, respond, fn, *args) -> None:
        pool = self._pool
        if pool is None:
            self._respond_quiet(
                respond, 503, {"message": "ingest router is stopping"}
            )
            return

        def run():
            try:
                fn(*args)
            except Exception as e:
                logger.exception("ingest router handler failed")
                self._respond_quiet(respond, 500, {"message": str(e)})

        try:
            pool.submit(run)
        except RuntimeError:
            self._respond_quiet(
                respond, 503, {"message": "ingest router is stopping"}
            )

    @callback_scope
    def _el_handle(self, req, respond) -> None:
        u = urllib.parse.urlparse(req.path)
        path = u.path
        if req.method == "POST":
            self.request_count += 1  # loop-thread only: no lock needed
            # mint a trace id when the client brought none, so every
            # routed write is flight-recordable and stitchable across
            # the router's and the shard owner's journals
            tid = (req.header(TRACE_HEADER) or "").strip() \
                or new_trace_id()
            if path == "/events.json":
                self._submit(respond, self._post_event,
                             req.path, req.body, respond, tid)
                return
            if path == "/batch/events.json":
                self._submit(respond, self._post_batch,
                             req.path, req.body, respond, tid)
                return
            if path.startswith("/webhooks/"):
                self._submit(respond, self._post_webhook,
                             req.path, path, req.body, respond, tid)
                return
            if path == "/stop":
                respond(200, {"message": "stopping"})
                threading.Thread(target=self.stop, daemon=True).start()
                return
            respond(404, {"message": "not found"})
            return
        if req.method == "GET":
            if path == "/metrics":
                if not metrics_enabled():
                    respond(404, {"message":
                                  "metrics disabled (--no-metrics)"})
                    return
                self._submit(respond, lambda: self._respond_quiet(
                    respond, 200, self.render_fleet_metrics(),
                    ctype=PROMETHEUS_CTYPE,
                ))
                return
            if path == "/stats.json":
                self._submit(respond, self._get_stats, req.path, respond)
                return
            if path == "/":
                respond(200, self.status_json())
                return
            if (path == "/events.json"
                    or (path.startswith("/events/")
                        and path.endswith(".json"))
                    or path.startswith("/webhooks/")):
                self._submit(respond, self._forward_read,
                             "GET", req.path, respond)
                return
            if path.startswith("/debug/"):
                # the other observability mounts (a profile capture
                # blocks for seconds) run on the pool, off the loop
                def obs():
                    ans = observability_response(path, u.query)
                    if ans is None:
                        self._respond_quiet(respond, 404,
                                            {"message": "not found"})
                        return
                    code, payload, ctype = ans
                    self._respond_quiet(respond, code, payload,
                                        ctype=ctype or "application/json")

                self._submit(respond, obs)
                return
        if req.method == "DELETE" and path.startswith("/events/"):
            # deletes fan to every shard file inside the worker; any
            # healthy worker can run one (sqlite arbitrates the writer
            # locks cross-process for this rare, non-hot-path op)
            self._submit(respond, self._forward_read,
                         "DELETE", req.path, respond)
            return
        respond(404, {"message": "not found"})


# -- worker process spawning -------------------------------------------------


def spawn_ingest_worker(index: int, n_workers: int, coord_dir,
                        wal_root=None, extra_args=()) -> dict:
    """Launch one shard-owner worker: ``python -m predictionio_tpu_torch
    eventserver`` on an ephemeral port with its shards striped for
    ``index`` (``--worker-index``/``--worker-count``), announcing through
    a port file (pair with `router.wait_for_port_file`).  Storage config
    rides the environment (``PIO_STORAGE_*``, ``PIO_TPU_HOME``); each
    worker's WAL lives under ``wal_root/worker-<index>`` so a respawn
    replays exactly its own acknowledged backlog."""
    coord_dir = Path(coord_dir)
    wal_root = Path(wal_root) if wal_root else coord_dir / "wal"
    return spawn_port_process(
        ["eventserver", "--ip", "127.0.0.1", "--port", "0",
         "--worker-index", str(index), "--worker-count", str(n_workers),
         "--wal-dir", str(wal_root / f"worker-{index}"), *extra_args],
        coord_dir, f"worker-{index}", index,
    )


def boot_ingest_fleet(n_workers: int, n_shards: int, coord_dir,
                      config: Optional[IngestRouterConfig] = None,
                      wal_root=None, extra_args=(), respawn: bool = True,
                      ) -> tuple[IngestRouterServer, list[dict]]:
    """Spawn ``n_workers`` shard-owner processes, wait for their port
    announcements, and return a wired (not yet bound) router plus the
    spawned dicts (each with its ``boot_s``, spawn to port
    announcement).  ``respawn`` attaches the supervisor so a killed
    worker comes back on its own.  A worker that fails to announce
    stops every worker spawned and raises."""
    t0 = time.perf_counter()
    spawned = [
        spawn_ingest_worker(
            i, n_workers, coord_dir,
            wal_root=wal_root, extra_args=extra_args,
        )
        for i in range(n_workers)
    ]
    workers = []
    try:
        for s in spawned:
            port = wait_for_port_file(s)
            s["boot_s"] = time.perf_counter() - t0
            workers.append(IngestWorker(
                f"worker-{s['index']}", "127.0.0.1", port,
                shards_for_worker(s["index"], n_workers, n_shards),
                s["index"],
            ))
    except BaseException:
        for s in spawned:
            if s["proc"].poll() is None:
                s["proc"].kill()
            s["proc"].wait()
        raise
    supervisor = None
    if respawn:
        supervisor = ReplicaSupervisor(
            spawner=lambda i: spawn_ingest_worker(
                i, n_workers, coord_dir,
                wal_root=wal_root, extra_args=extra_args,
            ),
        )
        for w, s in zip(workers, spawned):
            supervisor.attach(w, s)
    cfg = config or IngestRouterConfig(n_shards=n_shards)
    cfg.n_shards = n_shards
    return IngestRouterServer(workers, cfg, supervisor), spawned
