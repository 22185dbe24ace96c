"""The serving replica fleet's router, and the fleet helpers it shares
with the ingest router.

Port of ``predictionio_tpu/server/router.py``.  ``deploy --replicas N``
boots N single-replica ``deploy`` processes (each its own interpreter,
its own CUDA context on the card, its own ``/metrics``) and ONE router
process in front of them (:class:`RouterServer`, on the event-loop
edge: the loop parses and routes, a bounded pool does the blocking
upstream HTTP):

* **Routing**: ``POST /queries.json`` round-robins over healthy
  replicas on pooled keep-alive connections.  A transport failure
  (replica killed, connection refused, read timeout) marks the replica
  down, books a failover, and retries the SAME request on the next
  replica: predicts are idempotent, so the client sees one 200.  Only
  when every replica is unreachable does the router answer a structured
  503.  A ``?timeout=`` budget the fleet's measured round trip already
  exceeds is answered a structured 503 at the router (deadline
  admission).
* **Health**: a daemon thread polls each replica's ``GET /`` every
  ``health_interval_s`` (health, breaker, ``pio_replica_up`` and the
  model fields of its status), pulls its ``/metrics`` into the router's
  merged exposition, and ticks the :class:`ReplicaSupervisor`, which
  respawns a replica whose process died.
* **Rolling fold-in push**: ``POST /admin/push-foldin`` walks the
  replicas ONE AT A TIME, POSTing ``/foldin/apply`` so each patches the
  fold-in delta links published for its instance; at most one replica
  is applying at any moment, so the fleet never drops below N-1
  serving.  ``push_foldin_s`` (``deploy --replicas N --push-foldin
  SEC``) runs the same walk on a timer.
* **Tenancy**: ``POST /admin/tenants/weights`` and ``POST
  /admin/tenants`` are broadcast to every healthy replica (as
  ``/tenants/weights`` and ``/admin/tenants``), so every replica of a
  ``deploy --replicas N --multi`` fleet holds the same registry state
  and assigns every user the same variant; ``GET /debug/tenants``
  gathers each replica's registry document under its name.
* **Observability**: the forward histogram, ``router.forward`` and
  ``router.request`` spans, the ``router`` timeline family
  (admission/forward/replica/read/write), the router's own flight
  recorder, and ``/debug/fleet`` (the per-replica tail table), which any
  server in the router's process answers.

:class:`Replica`, :class:`ReplicaSupervisor` and the port-file protocol
(:func:`spawn_port_process`, :func:`wait_for_port_file`) also carry the
ingest router (``server/ingest_router.py``).
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Optional

from ..obs import (
    REPLICA_MODEL_FRESHNESS,
    REPLICA_REQUESTS_TOTAL,
    REPLICA_RESPAWNS_TOTAL,
    REPLICA_UP,
    ROUTER_ADMISSION_TOTAL,
    TRACE_HEADER,
    FlightRecorder,
    fleet,
    get_registry,
    get_tracer,
    metrics_enabled,
    new_trace_id,
    scope,
    timeline,
)
from ..resilience.policy import CircuitBreaker
from .eventloop import EventLoopHTTPServer, callback_scope
from .http_base import (
    PROMETHEUS_CTYPE,
    HTTPServerBase,
    observability_response,
)
from .microbatch import EwmaEstimator

__all__ = [
    "Replica",
    "ReplicaSupervisor",
    "RouterConfig",
    "RouterServer",
    "spawn_port_process",
    "spawn_replica",
    "wait_for_port_file",
]

logger = logging.getLogger(__name__)

# consecutive transport failures that open a process's breaker, and the
# seconds before it lets one probe through again
_BREAKER_FAILURES = 3
_BREAKER_RESET_S = 2.0
# respawn backoff: base * 2^attempts, capped
_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 30.0
# spawn to port announcement; a fleet worker boots in about 8 s, a
# serving replica loads its model and warms up on the card first
SPAWN_TIMEOUT_S = 180.0
# the router's health probe timeout, its forward timeout, and its pool
# of threads doing the blocking upstream HTTP
_HEALTH_TIMEOUT_S = 2.0
_FORWARD_TIMEOUT_S = 30.0
_FORWARD_THREADS = 16
# the tenancy admin routes the router broadcasts, and each replica's
# route it posts to
_BROADCASTS = {
    "/admin/tenants/weights": "/tenants/weights",
    "/admin/tenants": "/admin/tenants",
}


class Replica:
    """Router-side state for one server process: address, pooled
    keep-alive connections, breaker, health + last-seen status fields."""

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = port
        self.breaker = CircuitBreaker(
            failure_threshold=_BREAKER_FAILURES,
            reset_timeout_s=_BREAKER_RESET_S,
        )
        self._lock = threading.Lock()
        self._pool: list[http.client.HTTPConnection] = []
        # healthy starts True: a fresh fleet serves immediately and the
        # first failed forward/health-check flips it (optimistic start
        # beats rejecting the first second of traffic)
        self.healthy = True
        self.last_status: dict = {}
        self.last_error: Optional[str] = None
        self.forwarded = 0
        self.errors = 0
        self.failovers = 0
        # the process's last successfully scraped and parsed /metrics
        # state (a dump_state()-shaped dict), rebound whole on every good
        # scrape and never mutated: a process that dies keeps its last
        # good snapshot standing, so merged counters stay monotone
        self.metrics_state: Optional[dict] = None
        self.scrape_errors = 0
        self.last_scrape_at: Optional[float] = None
        self.last_scrape_error: Optional[str] = None
        self._m_scrape_err = fleet.REPLICA_SCRAPE_ERRORS.labels(
            replica=name)
        self._m_up = REPLICA_UP.labels(replica=name)
        self._m_fresh = REPLICA_MODEL_FRESHNESS.labels(replica=name)
        self._m_ok = REPLICA_REQUESTS_TOTAL.labels(
            replica=name, outcome="ok")
        self._m_err = REPLICA_REQUESTS_TOTAL.labels(
            replica=name, outcome="error")
        self._m_fail = REPLICA_REQUESTS_TOTAL.labels(
            replica=name, outcome="failover")
        self._m_up.set(1.0)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _connect(self, timeout_s: float) -> http.client.HTTPConnection:
        # fresh connections honor the CALLER's timeout: a stopped
        # process accepts the TCP handshake from its kernel backlog and
        # then never answers, which must not wedge a health sweep for
        # the long forward timeout
        c = http.client.HTTPConnection(self.host, self.port,
                                       timeout=timeout_s)
        c.connect()
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return c

    def request(self, method: str, path: str, body: Optional[bytes],
                timeout_s: float, trace_id: Optional[str] = None,
                tl=None) -> tuple[int, bytes, str]:
        """One upstream round trip on a pooled keep-alive connection,
        forwarding ``trace_id`` as ``X-PIO-Trace``.  Transport trouble
        raises OSError/http.client exceptions — the router's signal that
        the process is gone; HTTP error statuses return normally (an
        application 4xx/5xx is the process's answer, not a death).
        ``tl`` (a pulse Timeline) books the round trip's split:
        ``forward`` (pool or connect, and the send), ``replica`` (waiting
        for the response head) and ``read`` (the body)."""
        with self._lock:
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = self._connect(timeout_s)
        elif conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        try:
            hdrs = {"Content-Type": "application/json"}
            if trace_id:
                hdrs[TRACE_HEADER] = trace_id
            conn.request(method, path, body, headers=hdrs)
            if tl is not None:
                tl.mark("forward")
            r = conn.getresponse()
            if tl is not None:
                tl.mark("replica")
            data = r.read()
            if tl is not None:
                tl.mark("read")
            ctype = r.getheader("Content-Type",
                                "application/json") or "application/json"
            status = r.status
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise
        with self._lock:
            if len(self._pool) < 32:
                self._pool.append(conn)
            else:
                try:
                    conn.close()
                except OSError:
                    pass
        return status, data, ctype

    def mark_down(self, err: str) -> None:
        self.healthy = False
        self.last_error = err
        self.breaker.record_failure()
        self._m_up.set(0.0)
        # drop pooled connections: they point at a corpse
        with self._lock:
            pool, self._pool = self._pool, []
        for c in pool:
            try:
                c.close()
            except OSError:
                pass

    def mark_up(self, status: Optional[dict] = None) -> None:
        """Healthy again; ``status`` (its ``GET /`` document) becomes the
        last seen status, and its model freshness the fleet gauge's."""
        self.healthy = True
        self.last_error = None
        self.breaker.record_success()
        self._m_up.set(1.0)
        if status is not None:
            self.last_status = status
            fresh = status.get("modelFreshnessSec")
            if fresh is not None:
                self._m_fresh.set(float(fresh))

    def scrape(self, timeout_s: float) -> bool:
        """Pull and parse this process's ``/metrics`` into
        :attr:`metrics_state`.  Any failure — transport, HTTP status,
        exposition grammar — books a scrape error and leaves the previous
        snapshot standing; health marking is the health check's job."""
        try:
            status, data, _ = self.request("GET", "/metrics", None,
                                           timeout_s=timeout_s)
            if status != 200:
                raise RuntimeError(f"/metrics answered {status}")
            state = fleet.parse_prometheus(data.decode())
        except Exception as e:
            self.scrape_errors += 1
            self.last_scrape_error = f"{type(e).__name__}: {e}"
            self._m_scrape_err.inc()
            return False
        self.metrics_state = state
        self.last_scrape_at = time.time()
        self.last_scrape_error = None
        return True

    def snapshot(self) -> dict:
        out = {
            "name": self.name,
            "url": self.url,
            "healthy": self.healthy,
            "breaker": self.breaker.state,
            "forwarded": self.forwarded,
            "errors": self.errors,
            "failovers": self.failovers,
        }
        if self.scrape_errors:
            out["scrapeErrors"] = self.scrape_errors
        if self.last_error:
            out["lastError"] = self.last_error
        st = self.last_status
        for key in ("engineInstanceId", "requestCount", "modelFreshnessSec",
                    "foldinDeltasApplied"):
            if key in st:
                out[key] = st[key]
        return out


class ReplicaSupervisor:
    """Respawn-on-death for a fleet of server processes.  The router's
    health loop ticks the supervisor every sweep; a process that has
    exited is respawned through the fleet's own spawner, with capped
    exponential backoff between attempts so a crash-looping process
    cannot melt the box.

    The respawn itself (subprocess boot + port-file wait — seconds)
    runs on a per-replica background thread so one slow boot never
    stalls health sweeps for the rest of the fleet.
    """

    def __init__(self, spawner):
        # spawner(index) -> spawned dict (spawn_port_process shape)
        self.spawner = spawner
        self._lock = threading.Lock()
        # replica name -> {"spawned", "index", "attempts", "next_try",
        #                  "busy"}
        self._procs: dict[str, dict] = {}
        self.respawns = 0

    def attach(self, replica: Replica, spawned: dict) -> None:
        with self._lock:
            self._procs[replica.name] = {
                "spawned": spawned,
                "index": spawned["index"],
                "attempts": 0,
                "next_try": 0.0,
                "busy": False,
            }

    def live_procs(self) -> list:
        """Every currently-tracked subprocess (fleet teardown reaps
        these, not the boot-time list — respawns replace entries)."""
        with self._lock:
            return [st["spawned"]["proc"] for st in self._procs.values()]

    def tick(self, replicas: list[Replica]) -> None:
        """One health-loop sweep: respawn any replica whose process
        has exited (past its backoff), reset backoff for replicas that
        are alive AND healthy again."""
        now = time.monotonic()
        for replica in replicas:
            with self._lock:
                st = self._procs.get(replica.name)
                if st is None or st["busy"]:
                    continue
                proc = st["spawned"]["proc"]
                if proc.poll() is None:
                    if replica.healthy:
                        st["attempts"] = 0
                    continue
                if now < st["next_try"]:
                    continue
                st["busy"] = True
            threading.Thread(
                target=self._respawn, args=(replica,),
                daemon=True, name=f"respawn-{replica.name}",
            ).start()

    def _backoff(self, st: dict) -> None:
        """Count one attempt and push the next one out (called under
        the lock)."""
        st["attempts"] += 1
        st["next_try"] = time.monotonic() + min(
            _BACKOFF_CAP_S, _BACKOFF_BASE_S * (2.0 ** st["attempts"]),
        )
        st["busy"] = False

    def _respawn(self, replica: Replica) -> None:
        name = replica.name
        with self._lock:
            st = self._procs[name]
            index = st["index"]
        try:
            spawned = self.spawner(index)
            port = wait_for_port_file(spawned)
        except Exception as e:
            logger.warning("respawn of %s failed: %s", name, e)
            with self._lock:
                self._backoff(st)
            return
        # point the router at the new process: update the port, drop
        # pooled connections to the corpse (mark_down does), and let
        # the next health tick flip it healthy
        replica.port = port
        replica.mark_down(f"respawned on port {port}; awaiting health")
        REPLICA_RESPAWNS_TOTAL.labels(replica=name).inc()
        with self._lock:
            st["spawned"] = spawned
            self.respawns += 1
            # successful respawns back off too: a crash-looping process
            # respawns at the capped cadence, not as fast as it dies
            self._backoff(st)
        logger.info("respawned %s on port %d", name, port)

    def summary(self) -> dict:
        with self._lock:
            return {
                "respawns": self.respawns,
                "tracked": len(self._procs),
                "backoffCapSec": _BACKOFF_CAP_S,
            }


# the console on the host: `python -m predictionio_tpu_torch` always
# takes the card, so a fleet deployed on the CPU starts its replicas so
_CPU_CONSOLE = ("import sys; from predictionio_tpu_torch.cli.main import "
                "main; sys.exit(main(sys.argv[1:], device='cpu'))")


def spawn_port_process(argv: list, coord_dir, name: str, index: int,
                       on_cpu: bool = False) -> dict:
    """Launch ``python -m predictionio_tpu_torch <argv> --port-file F``
    (the console on the host with ``on_cpu``) as a subprocess that
    announces its bound port through the file ``coord_dir/<name>.port``
    (its output goes to ``<name>.log`` beside it).  Returns
    ``{"proc", "port_file", "log_path", "index"}``; pair with
    :func:`wait_for_port_file`."""
    coord_dir = Path(coord_dir)
    coord_dir.mkdir(parents=True, exist_ok=True)
    port_file = coord_dir / f"{name}.port"
    port_file.unlink(missing_ok=True)
    log_path = coord_dir / f"{name}.log"
    # the child must resolve the package regardless of the caller's cwd
    pkg_root = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + pp if pp else "")
    console = ["-c", _CPU_CONSOLE] if on_cpu else [
        "-m", "predictionio_tpu_torch"]
    cmd = [sys.executable, *console, *argv, "--port-file", str(port_file)]
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            cmd, stdout=log_f, stderr=subprocess.STDOUT, env=env,
        )
    return {"proc": proc, "port_file": port_file,
            "log_path": log_path, "index": index}


def wait_for_port_file(spawned: dict,
                       timeout_s: float = SPAWN_TIMEOUT_S) -> int:
    """Block until the process announces its bound port (or dies)."""
    port_file = spawned["port_file"]
    proc = spawned["proc"]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if port_file.exists():
            text = port_file.read_text()
            # the writer ends the port with a newline: a partial read
            # of a file still being written is not a port
            if text.endswith("\n"):
                return int(text)
        if proc.poll() is not None:
            tail = ""
            try:
                tail = Path(spawned["log_path"]).read_text()[-2000:]
            except OSError:
                pass
            raise RuntimeError(
                f"process {spawned['index']} exited rc={proc.returncode} "
                f"before announcing a port; log tail:\n{tail}"
            )
        time.sleep(0.05)
    raise TimeoutError(
        f"process {spawned['index']} did not announce a port within "
        f"{timeout_s}s"
    )


def spawn_replica(engine_args: list, index: int, coord_dir,
                  extra_args=(), on_cpu: bool = False) -> dict:
    """Launch one serving replica: ``python -m predictionio_tpu_torch
    deploy <engine_args> --ip 127.0.0.1 --port 0 --port-file F``
    (``engine_args``: ``--engine NAME`` or ``--engine-json PATH``), its
    log ``replica-<index>.log`` in ``coord_dir``; pair with
    :func:`wait_for_port_file`."""
    return spawn_port_process(
        ["deploy", *engine_args, "--ip", "127.0.0.1", "--port", "0",
         *extra_args],
        coord_dir, f"replica-{index}", index, on_cpu=on_cpu,
    )


class RouterConfig:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 health_interval_s: float = 1.0,
                 max_connections: int = 1024,
                 push_foldin_s: Optional[float] = None,
                 slo_ms: Optional[float] = None):
        self.host = host
        self.port = port
        self.health_interval_s = health_interval_s
        self.max_connections = max_connections
        # the rolling fold-in push's period (None: only on demand,
        # through POST /admin/push-foldin)
        self.push_foldin_s = push_foldin_s
        # arms the router-side pio_slo_burn_rate{window} gauges on the
        # forward round-trip histogram
        self.slo_ms = slo_ms


class RouterServer(HTTPServerBase):
    """The serving fleet's front door; see the module docstring."""

    server_name = "router"

    def __init__(self, replicas: list[Replica],
                 config: Optional[RouterConfig] = None,
                 supervisor: Optional[ReplicaSupervisor] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = replicas
        self.config = config or RouterConfig()
        self.supervisor = supervisor
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._rr_lock = threading.Lock()
        self._rr = 0
        self._stop_event = threading.Event()
        self.start_time = time.time()  # wall clock: a TIMESTAMP
        self.request_count = 0
        self.unroutable = 0
        # deadline admission: an EWMA of the replicas' round trips (the
        # micro-batcher's estimator); a ?timeout= budget it already
        # exceeds is answered 503 here, without a doomed forward.
        # Seeded 0: a cold router never sheds
        self._ewma_forward = EwmaEstimator()
        self._ewma_lock = threading.Lock()
        self.admission_rejected = 0
        self._m_adm_ok = ROUTER_ADMISSION_TOTAL.labels(outcome="admitted")
        self._m_adm_rej = ROUTER_ADMISSION_TOTAL.labels(outcome="rejected")
        # the router's own flight recorder: worst-N proxied requests with
        # the replica that served each (the process recorder would mix
        # in an in-process replica's serve.query offers)
        self.flight = FlightRecorder()
        self._m_forward = fleet.ROUTER_FORWARD_SECONDS.child()
        self._burn = None
        if self.config.slo_ms:
            self._burn = fleet.install_burn_rate(
                self._m_forward, self.config.slo_ms / 1e3
            )
        fleet.set_fleet_provider(self.fleet_payload)
        self._health_thread: Optional[threading.Thread] = None
        self._push_thread: Optional[threading.Thread] = None
        self._push_lock = threading.Lock()  # one rolling push at a time

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
                max_workers=_FORWARD_THREADS,
                thread_name_prefix="router-fwd",
                initializer=scope.register_thread_role,
                initargs=("router_fwd",),
            )
        if self._health_thread is None:
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True, name="router-health"
            )
            self._health_thread.start()
        if self.config.push_foldin_s and self._push_thread is None:
            self._push_thread = threading.Thread(
                target=self._push_loop, daemon=True, name="router-push"
            )
            self._push_thread.start()
        # the router is the fleet's one event loop: always profile it
        scope.ensure_started()
        return EventLoopHTTPServer(
            (self.host, self.port), self._el_handle,
            max_connections=self.config.max_connections,
            name="router",
        )

    def stop(self) -> None:
        super().stop()
        self._stop_event.set()
        # clear the provider only if this router is still the installed
        # one (a second router in the process may have replaced it)
        if fleet._fleet_provider == self.fleet_payload:
            fleet.set_fleet_provider(None)
        if self._health_thread is not None:
            self._health_thread.join(
                timeout=self.config.health_interval_s
                + 2 * _HEALTH_TIMEOUT_S * len(self.replicas)
            )
            self._health_thread = None
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- health ------------------------------------------------------------
    def check_replica(self, replica: Replica) -> bool:
        try:
            status, data, _ = replica.request(
                "GET", "/", None, timeout_s=_HEALTH_TIMEOUT_S)
            if status != 200:
                replica.mark_down(f"status {status}")
                return False
            replica.mark_up(json.loads(data.decode()))
            return True
        except Exception as e:
            replica.mark_down(f"{type(e).__name__}: {e}")
            return False

    def _health_loop(self) -> None:
        scope.register_thread_role("health_loop")
        while not self._stop_event.wait(self.config.health_interval_s):
            for r in self.replicas:
                self.check_replica(r)
            # a dead replica's scrape fails fast and leaves its last good
            # snapshot standing: the merged counters stay monotone
            for r in self.replicas:
                r.scrape(_HEALTH_TIMEOUT_S)
            if self.supervisor is not None:
                try:
                    self.supervisor.tick(self.replicas)
                except Exception:
                    logger.exception("replica supervisor tick failed")

    # -- rolling fold-in push ---------------------------------------------
    def push_foldin(self) -> dict:
        """Walk the fleet ONE replica at a time, telling each to apply
        its pending fold-in delta links now (``POST /foldin/apply``).
        Sequential by construction: mid-push at most the one replica
        applying is busy (and its apply is in place), so availability
        never drops below N-1.  A replica that cannot be reached is
        marked down; an unhealthy one is skipped."""
        results = []
        with self._push_lock:
            for r in self.replicas:
                if not r.healthy:
                    results.append({"replica": r.name,
                                    "skipped": "unhealthy"})
                    continue
                try:
                    status, data, _ = r.request(
                        "POST", "/foldin/apply", b"{}",
                        timeout_s=_FORWARD_TIMEOUT_S,
                    )
                    body = json.loads(data.decode())
                    entry = {"replica": r.name, "status": status}
                    entry.update({
                        k: body[k] for k in
                        ("applied", "modelFreshnessSec",
                         "foldinDeltasApplied")
                        if k in body
                    })
                    results.append(entry)
                    fresh = body.get("modelFreshnessSec")
                    if fresh is not None:
                        r._m_fresh.set(float(fresh))
                except Exception as e:
                    r.mark_down(f"{type(e).__name__}: {e}")
                    results.append({
                        "replica": r.name,
                        "error": f"{type(e).__name__}: {e}",
                    })
        return {"pushed": results}

    def broadcast_post(self, target: str, body: bytes) -> dict:
        """POST ``body`` to ``target`` on every healthy replica in turn:
        ``{"pushed": [...]}``, each entry the replica's name and status
        with its reply's fields, ``skipped`` for an unhealthy one, or
        the transport error that marked it down."""
        results = []
        for r in self.replicas:
            if not r.healthy:
                results.append({"replica": r.name, "skipped": "unhealthy"})
                continue
            try:
                status, data, _ = r.request("POST", target, body,
                                            timeout_s=_FORWARD_TIMEOUT_S)
                entry = {"replica": r.name, "status": status}
                try:
                    entry.update(json.loads(data.decode()))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    pass
                results.append(entry)
            except Exception as e:
                r.mark_down(f"{type(e).__name__}: {e}")
                results.append({"replica": r.name,
                                 "error": f"{type(e).__name__}: {e}"})
        return {"pushed": results}

    def gather_tenants(self) -> dict:
        """Every replica's ``GET /debug/tenants`` document under its
        name (its status, or its transport error, when it gave none)."""
        out = {}
        for r in self.replicas:
            try:
                status, data, _ = r.request("GET", "/debug/tenants", None,
                                            timeout_s=_HEALTH_TIMEOUT_S)
                out[r.name] = (json.loads(data.decode()) if status == 200
                               else {"status": status})
            except Exception as e:
                out[r.name] = {"error": f"{type(e).__name__}: {e}"}
        return {"replicas": out}

    def _push_loop(self) -> None:
        scope.register_thread_role("push_loop")
        while not self._stop_event.wait(self.config.push_foldin_s):
            try:
                self.push_foldin()
            except Exception:
                logger.exception("rolling fold-in push failed")

    # -- forwarding --------------------------------------------------------
    def _candidates(self) -> list[Replica]:
        with self._rr_lock:
            self._rr += 1
            start = self._rr
        n = len(self.replicas)
        order = [self.replicas[(start + i) % n] for i in range(n)]
        healthy = [r for r in order if r.healthy]
        # last resort: unhealthy replicas whose breaker grants a probe
        # (a recovered replica takes traffic before the next health tick)
        probes = [r for r in order if not r.healthy and r.breaker.allow()]
        return healthy + probes

    def _forward_query(self, path_qs: str, body: bytes, trace_id: str,
                       respond, tl, est_at_admission: float) -> None:
        """The pool's half of the hot path: try the candidates in order
        until one answers; a transport failure marks its replica down,
        books a failover and goes on to the next.  The served request
        feeds the admission estimator, the forward histogram (its trace
        id the bucket exemplar), the ``router.forward`` and
        ``router.request`` spans and the router's flight recorder, with
        the serving replica's name and the replicas that failed it."""
        hdrs_out = [(TRACE_HEADER, trace_id)]
        last_err = "no replicas configured"
        failed: list[str] = []
        for i, replica in enumerate(self._candidates()):
            t0 = time.perf_counter()
            wall0 = time.time()
            try:
                status, data, ctype = replica.request(
                    "POST", path_qs, body, timeout_s=_FORWARD_TIMEOUT_S,
                    trace_id=trace_id, tl=tl,
                )
            except Exception as e:
                last_err = f"{replica.name}: {type(e).__name__}: {e}"
                replica.errors += 1
                replica.failovers += 1
                replica._m_fail.inc()
                replica.mark_down(last_err)
                failed.append(replica.name)
                continue
            if not replica.healthy:
                replica.mark_up()
            replica.forwarded += 1
            rt = time.perf_counter() - t0
            # success paths only: a failover's timeout would teach the
            # estimator to shed everything
            with self._ewma_lock:
                self._ewma_forward.observe(rt)
            self._m_forward.observe(rt, exemplar=trace_id)
            (replica._m_ok if status < 500 else replica._m_err).inc()
            tracer = get_tracer()
            tracer.record("router.forward", rt, trace_id=trace_id,
                          attrs={"replica": replica.name, "status": status},
                          start=wall0)
            total = tl.elapsed()
            attrs = {
                "replica": replica.name,
                "status": status,
                "ewmaAtAdmissionSec": round(est_at_admission, 6),
                "roundTripSec": round(rt, 6),
                "segmentsMs": tl.snapshot_ms(),
            }
            if failed:
                # the replicas that ate the time before this one answered
                attrs["failedReplicas"] = failed
            if i:
                attrs["failovers"] = i
            tracer.record("router.request", total, trace_id=trace_id,
                          attrs=attrs, start=time.time() - total)
            # offered after the spans land, so a record's tree holds them
            self.flight.offer(trace_id, total, name="router.request",
                              attrs=attrs)
            try:
                respond(status, data, ctype=ctype, extra_headers=hdrs_out,
                        tl=tl)
            except RuntimeError:
                pass
            return
        self.unroutable += 1
        try:
            respond(503, {
                "message": f"no replica available ({last_err})",
                "error": "NoReplicaAvailable",
            }, extra_headers=hdrs_out + [("Retry-After", "1")])
        except RuntimeError:
            pass

    # -- merged exposition and the fleet tail view -------------------------
    def render_fleet_metrics(self) -> bytes:
        """The router's ``GET /metrics``: its own registry merged with
        every replica's last scraped snapshot (counters and histograms
        sum, gauges gain a ``{replica}`` label).  A schema drift between
        replicas falls back to the router's own exposition, logged."""
        tagged = [("router", get_registry().dump_state())]
        for r in self.replicas:
            state = r.metrics_state
            if state is not None:
                tagged.append((r.name, state))
        try:
            return fleet.render_fleet(tagged).encode()
        except ValueError as e:
            logger.warning("fleet metrics merge failed (%s); serving the "
                           "router-local exposition", e)
            return get_registry().render_prometheus().encode()

    def _replica_tail_entry(self, r: Replica) -> dict:
        entry = r.snapshot()
        entry["respawns"] = REPLICA_RESPAWNS_TOTAL.labels(
            replica=r.name).value()
        state = r.metrics_state
        if state is not None:
            hist = fleet.state_histogram(state, "pio_query_latency_seconds")
            if hist and hist["count"]:
                entry["p50Ms"] = round(fleet.hist_quantile(hist, 50) * 1e3, 3)
                entry["p99Ms"] = round(fleet.hist_quantile(hist, 99) * 1e3, 3)
                entry["latencyCount"] = hist["count"]
            entry["queriesTotal"] = fleet.state_counter_total(
                state, "pio_queries_total")
            if r.last_scrape_at is not None:
                entry["scrapeAgeSec"] = round(
                    max(time.time() - r.last_scrape_at, 0.0), 3)
        if r.last_scrape_error:
            entry["lastScrapeError"] = r.last_scrape_error
        return entry

    def _enrich_worst(self, worst: list) -> list:
        """Join each of the first worst-N records with the serving
        replica's own record of that trace (``GET /debug/flight?trace=``:
        its segment split beside the router's round trip), fetched once
        and kept in the router's flight attrs."""
        by_name = {r.name: r for r in self.replicas}
        for w in worst[:8]:
            attrs = w.get("attrs") or {}
            if "replicaSegmentsMs" in attrs or "replica" not in attrs:
                continue
            replica = by_name.get(attrs["replica"])
            if replica is None or not replica.healthy:
                continue
            try:
                status, data, _ = replica.request(
                    "GET",
                    "/debug/flight?trace="
                    + urllib.parse.quote(w["traceId"]),
                    None, timeout_s=_HEALTH_TIMEOUT_S,
                )
                if status != 200:
                    continue
                rec = json.loads(data.decode()).get("record")
            except Exception:
                continue
            if not rec:
                continue
            extra = {
                "replicaDurationSec": rec.get("durationSec"),
                "replicaSegmentsMs": (rec.get("attrs") or {}).get(
                    "segmentsMs"),
            }
            self.flight.annotate(w["traceId"], extra)
            attrs.update(extra)
            w["attrs"] = attrs
        return worst

    def fleet_payload(self) -> dict:
        """``GET /debug/fleet``: the per-replica tail table (p50/p99 from
        the scrapes, breaker, failovers and respawns) and the router
        flight recorder's worst-N with the serving replica's split."""
        summary = self.flight.summary()
        out = {
            "role": "router",
            "replicas": [self._replica_tail_entry(r) for r in self.replicas],
            "healthyReplicas": sum(r.healthy for r in self.replicas),
            "requestCount": self.request_count,
            "unroutable": self.unroutable,
            "admissionRejected": self.admission_rejected,
            "ewmaForwardSec": self._ewma_forward.value,
            "scrapeErrors": sum(r.scrape_errors for r in self.replicas),
            "flight": {
                "capacity": summary["capacity"],
                "offers": summary["offers"],
                "admissions": summary["admissions"],
            },
            "worst": self._enrich_worst(summary["worst"]),
        }
        if self.config.slo_ms:
            out["sloMs"] = self.config.slo_ms
            out["burnRate"] = {
                name: round(self._burn.rate(secs), 4)
                for name, secs in fleet.BURN_WINDOWS
            }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.summary()
        return out

    # -- http --------------------------------------------------------------
    def status_json(self) -> dict:
        out = {
            "status": "alive",
            "role": "router",
            "replicas": [r.snapshot() for r in self.replicas],
            "healthyReplicas": sum(r.healthy for r in self.replicas),
            "requestCount": self.request_count,
            "unroutable": self.unroutable,
            "admissionRejected": self.admission_rejected,
            "ewmaForwardSec": self._ewma_forward.value,
            "startTime": self.start_time,
            "maxConnections": self.config.max_connections,
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.summary()
        return out

    def _on_pool(self, respond, fn) -> None:
        """Run ``fn() -> (code, payload, ctype)`` on the forward pool and
        answer from there; 503 once the router is stopping."""
        def run():
            try:
                code, payload, ctype = fn()
            except Exception as e:
                logger.exception("router route failed")
                code, payload, ctype = 500, {"message": str(e)}, None
            try:
                respond(code, payload, ctype=ctype or "application/json")
            except RuntimeError:
                pass  # client hung up first

        pool = self._pool
        try:
            if pool is None:
                raise RuntimeError("no pool")
            pool.submit(run)
        except RuntimeError:
            respond(503, {"message": "router is stopping"})

    def _admit(self, query: str, tid: str, respond) -> Optional[float]:
        """Deadline admission of a ``POST /queries.json``: the EWMA
        estimate it was admitted at, or None once it was answered a
        structured 503 (a ``?timeout=`` budget the fleet's round trip
        already exceeds).  No timeout, or a cold estimator, admits."""
        est = self._ewma_forward.value
        tv = urllib.parse.parse_qs(query).get("timeout")
        if not tv:
            return est
        try:
            budget = float(tv[0])
        except ValueError:
            budget = None
        if budget is not None and est > 0.0 and (budget <= 0.0
                                                 or est > budget):
            self.admission_rejected += 1  # loop thread only
            self._m_adm_rej.inc()
            respond(503, {
                "message": (f"estimated fleet round-trip {est * 1e3:.1f}ms "
                            f"exceeds the {budget * 1e3:.1f}ms request "
                            "budget"),
                "error": "AdmissionRejected",
            }, extra_headers=[("Retry-After", "1"), (TRACE_HEADER, tid)])
            return None
        self._m_adm_ok.inc()
        return est

    @callback_scope
    def _el_handle(self, req, respond) -> None:
        u = urllib.parse.urlparse(req.path)
        path = u.path
        if req.method == "POST" and path == "/queries.json":
            self.request_count += 1  # loop thread only: no lock needed
            # a trace id minted when the client brought none: every
            # proxied request is stitchable across the journals
            tid = (req.header(TRACE_HEADER) or "").strip() or new_trace_id()
            tl = timeline.Timeline("router")
            est = self._admit(u.query, tid, respond)
            if est is None:
                return
            tl.mark("admission")
            pool = self._pool
            try:
                if pool is None:
                    raise RuntimeError("no pool")
                pool.submit(self._forward_query, req.path, req.body, tid,
                            respond, tl, est)
            except RuntimeError:
                respond(503, {"message": "router is stopping"})
            return
        if req.method == "POST" and path in _BROADCASTS:
            # a weight update or a tenant's add/remove goes to every
            # replica: the same registry everywhere assigns every user
            # the same variant everywhere
            target, body = _BROADCASTS[path], req.body
            self._on_pool(respond, lambda: (
                200, self.broadcast_post(target, body), None))
            return
        if req.method == "GET" and path == "/debug/tenants":
            self._on_pool(respond, lambda: (200, self.gather_tenants(),
                                            None))
            return
        if req.method == "POST" and path == "/admin/push-foldin":
            # blocking upstream round trips: on the pool
            self._on_pool(respond, lambda: (200, self.push_foldin(), None))
            return
        if req.method == "POST" and path == "/stop":
            respond(200, {"message": "stopping"})
            threading.Thread(target=self.stop, daemon=True).start()
            return
        if req.method == "GET" and path == "/metrics":
            # the fleet's exposition, rendered on the pool
            if not metrics_enabled():
                respond(404, {"message": "metrics disabled (--no-metrics)"})
                return
            self._on_pool(respond, lambda: (
                200, self.render_fleet_metrics(), PROMETHEUS_CTYPE))
            return
        if req.method == "GET" and path == "/":
            respond(200, self.status_json())
            return
        if req.method == "GET" and path == "/debug/fleet":
            # lazy replica /debug/flight fetches block: on the pool
            self._on_pool(respond, lambda: (200, self.fleet_payload(), None))
            return
        if req.method == "GET" and path.startswith("/debug/"):
            # /debug/profile captures for seconds: every mount runs on
            # the pool
            def obs():
                ans = observability_response(path, u.query)
                return ans if ans is not None else (
                    404, {"message": "not found"}, None)

            self._on_pool(respond, obs)
            return
        respond(404, {"message": "not found"})
