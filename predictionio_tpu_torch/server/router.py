"""Fleet helpers: the router-side view of one server process, its
respawn supervisor and the port-file spawn protocol.

Port of the helpers of ``predictionio_tpu/server/router.py`` that the
ingest router (``server/ingest_router.py``) is built on: ``Replica``
(pooled keep-alive connections, a circuit breaker, health fields),
``ReplicaSupervisor`` (respawn-on-death with capped backoff) and the
port-file protocol (``spawn_port_process``, ``wait_for_port_file``).
Not ported yet: ``RouterServer``, the serving replica fleet behind
``deploy --replicas N``, with its ``spawn_replica`` (ROADMAP Queue 1
item 4), with each replica's failover count, the model fields of its
health and the router's forward counters.  ``Replica.scrape`` pulls a
process's ``/metrics`` for the ingest router's federation.
"""

from __future__ import annotations

import http.client
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from ..obs import REPLICA_UP, TRACE_HEADER, fleet
from ..resilience.policy import CircuitBreaker

__all__ = [
    "Replica",
    "ReplicaSupervisor",
    "spawn_port_process",
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
# spawn to port announcement; a fleet worker boots in about 8 s
SPAWN_TIMEOUT_S = 60.0


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
        self.last_error: Optional[str] = None
        self.forwarded = 0
        self.errors = 0
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
                timeout_s: float,
                trace_id: Optional[str] = None) -> tuple[int, bytes, str]:
        """One upstream round trip on a pooled keep-alive connection,
        forwarding ``trace_id`` as ``X-PIO-Trace``.  Transport trouble
        raises OSError/http.client exceptions — the router's signal that
        the process is gone; HTTP error statuses return normally (an
        application 4xx/5xx is the process's answer, not a death)."""
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
            r = conn.getresponse()
            data = r.read()
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

    def mark_up(self) -> None:
        self.healthy = True
        self.last_error = None
        self.breaker.record_success()
        self._m_up.set(1.0)

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
        }
        if self.scrape_errors:
            out["scrapeErrors"] = self.scrape_errors
        if self.last_error:
            out["lastError"] = self.last_error
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


def spawn_port_process(argv: list, coord_dir, name: str,
                       index: int) -> dict:
    """Launch ``python -m predictionio_tpu_torch <argv> --port-file F``
    as a subprocess that announces its bound port through the file
    ``coord_dir/<name>.port`` (its output goes to ``<name>.log``
    beside it).  Returns ``{"proc", "port_file", "log_path", "index"}``;
    pair with :func:`wait_for_port_file`."""
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
    cmd = [sys.executable, "-m", "predictionio_tpu_torch",
           *argv, "--port-file", str(port_file)]
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
