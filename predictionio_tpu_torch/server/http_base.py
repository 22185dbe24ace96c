"""Shared HTTP server plumbing: bind/serve/stop lifecycle, a capped
threading server, a JSON reply helper and the observability mounts
(``GET /metrics`` and ``/debug/*``) every port server answers.

Port of ``predictionio_tpu/server/http_base.py``.  The lifecycle drives
either edge: the capped threading server built here, or the
``eventloop.EventLoopHTTPServer`` a subclass's ``_build_httpd`` returns
(``EngineServer`` on its default edge).
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ..obs import (
    HTTP_CONN_REJECTED,
    TRACE_HEADER,
    metrics_enabled,
    render_prometheus,
)

__all__ = [
    "DEFAULT_MAX_CONNECTIONS",
    "OBS_PATHS",
    "CappedThreadingHTTPServer",
    "HTTPServerBase",
    "JsonRequestHandler",
    "observability_response",
]

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"

# per-server default for the concurrent-connection cap: past it, a
# connection is answered a structured 503 and closed instead of pinning
# one more handler thread
DEFAULT_MAX_CONNECTIONS = 512


class CappedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a bound on concurrent connections.

    Each accepted connection (keep-alive included) holds one handler
    thread until it closes; past ``max_connections`` of them, further
    connections are answered with a minimal structured 503 and closed
    instead of spawning thread number cap+1.  The refusal is written
    inline on the listener thread — a few hundred bytes into a fresh
    socket's send buffer never blocks.

    The listen backlog is the connection cap, not socketserver's 5: with
    5, a burst of a few dozen new connections overflows the accept queue
    and the kernel resets some of them before the cap is ever consulted.

    ``server_close`` also shuts the open connections: a keep-alive
    connection's handler thread would otherwise go on answering its
    client after the server stopped (a router's pooled connection to a
    stopped worker would still read it healthy).
    """

    def __init__(self, server_address, handler_class,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 server_name: str = "serving"):
        self.max_connections = max_connections
        self.request_queue_size = max_connections
        self._conn_sema = threading.BoundedSemaphore(max_connections)
        self._m_rejected = HTTP_CONN_REJECTED.labels(server=server_name)
        self._open: set[socket.socket] = set()
        self._open_lock = threading.Lock()
        super().__init__(server_address, handler_class)

    def process_request(self, request, client_address):
        if not self._conn_sema.acquire(blocking=False):
            self._m_rejected.inc()
            self._refuse(request)
            return
        with self._open_lock:
            self._open.add(request)
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._forget(request)
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._forget(request)

    def _forget(self, request) -> None:
        with self._open_lock:
            self._open.discard(request)
        self._conn_sema.release()

    def server_close(self) -> None:
        super().server_close()
        with self._open_lock:
            open_now = list(self._open)
        for request in open_now:
            try:
                request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _refuse(self, request) -> None:
        body = json.dumps({
            "message": "connection limit reached",
            "error": "TooManyConnections",
        }).encode()
        try:
            request.sendall(
                b"HTTP/1.1 503 Service Unavailable\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Retry-After: 1\r\nConnection: close\r\n\r\n" + body
            )
        except OSError:
            pass
        self.shutdown_request(request)


OBS_PATHS = ("/metrics", "/debug/xray", "/debug/train", "/debug/profile",
             "/debug/flight", "/debug/fleet", "/debug/pprof")


def observability_response(path: str, query: str = ""):
    """Answer the common observability mounts shared by every server
    (both edges): returns ``(code, payload, ctype)`` or ``None`` when
    ``path`` is not an observability mount.  ``/debug/profile`` BLOCKS
    for the capture duration — event-loop callers must run this off
    the loop (the serving edge routes all GETs through its aux pool)."""
    if path not in OBS_PATHS:
        return None
    if not metrics_enabled():
        return 404, {"message": "metrics disabled (--no-metrics)"}, None
    if path == "/debug/xray":
        from ..obs.xray import xray_payload

        return 200, xray_payload(), None
    if path == "/debug/train":
        from ..obs.tower import train_payload

        return 200, train_payload(), None
    if path == "/debug/flight":
        # pio-lens: the process flight recorder, addressable by trace
        # id — the router's /debug/fleet lazily joins a worst-N entry
        # with the serving replica's own record through this mount
        from ..obs import get_flight_recorder

        qs = urllib.parse.parse_qs(query)
        trace = qs.get("trace", [None])[0]
        fr = get_flight_recorder()
        if trace:
            return 200, {"record": fr.record_for(trace)}, None
        spans = qs.get("spans", ["0"])[0] not in ("0", "", "false")
        return 200, fr.summary(spans=spans), None
    if path == "/debug/fleet":
        # answered for real by a RouterServer (its own handler builds
        # the payload); on other servers this mount reports whether a
        # router lives in-process (the dashboard's fleet.html reads it)
        from ..obs import fleet

        payload = fleet.fleet_payload()
        if payload is None:
            return 404, {"message": "no router in this process "
                         "(curl the router's /debug/fleet)"}, None
        return 200, payload, None
    if path == "/debug/pprof":
        # pio-scope: collapsed-stack text from the always-on sampler's
        # rolling ring — answers instantly from history (safe on the
        # event loop, unlike /debug/profile's capture-for-S-seconds)
        from ..obs import scope

        qs = urllib.parse.parse_qs(query)
        try:
            seconds = float(qs.get("seconds", ["60"])[0])
        except ValueError:
            return 400, {"message":
                         f"bad seconds: {qs['seconds'][0]!r}"}, None
        state = qs.get("state", [None])[0]
        if state in ("", "all"):
            state = None
        if state not in (None, "running", "waiting"):
            return 400, {"message": f"bad state: {state!r} "
                         "(running|waiting|all)"}, None
        prof = scope.get_profiler()
        text = prof.collapsed(
            seconds, state=state, role=qs.get("role", [None])[0] or None
        )
        head = (
            f"# pio-scope folded stacks seconds={seconds:g} "
            f"hz={prof.hz:g} running={int(scope.profiler_running())}\n"
        )
        return 200, (head + text).encode(), "text/plain; charset=utf-8"
    if path == "/debug/profile":
        from ..obs import timeline

        qs = urllib.parse.parse_qs(query)
        try:
            seconds = float(qs.get("seconds", ["2"])[0])
        except ValueError:
            return 400, {"message": f"bad seconds: {qs['seconds'][0]!r}"}, None
        try:
            return 200, timeline.capture_profile(seconds), None
        except timeline.ProfileBusy as e:
            return 409, {"message": str(e)}, None
        except Exception as e:
            return 500, {"message": f"profile capture failed: {e}"}, None
    return 200, render_prometheus().encode(), PROMETHEUS_CTYPE


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Base handler: HTTP/1.1 keep-alive + JSON/body helpers."""

    protocol_version = "HTTP/1.1"
    # the reply is two send() calls (buffered headers, then body); without
    # TCP_NODELAY, Nagle holds the body segment until the client's
    # delayed ACK, a ~40 ms stall on every keep-alive POST
    disable_nagle_algorithm = True
    server_logger = None  # subclasses set a logging.Logger

    def log_message(self, fmt, *args):
        if self.server_logger is not None:
            self.server_logger.debug(fmt, *args)

    def _serve_metrics(self) -> bool:
        """Answer the common observability mounts — ``GET /metrics``
        (Prometheus exposition), ``GET /debug/xray`` (compiler/device/
        flight-recorder JSON, pio-xray), ``GET /debug/train`` (training
        run progress + manifest history, pio-tower) and ``GET
        /debug/profile`` (blocking on-demand torch.profiler
        capture, pio-pulse) — from the process-wide registry.  Every server's
        ``do_GET`` tries this first, so every port server exposes
        the same set without per-server code.  Returns True when the
        request was handled."""
        u = urllib.parse.urlparse(self.path)
        ans = observability_response(u.path, u.query)
        if ans is None:
            return False
        code, payload, ctype = ans
        self._reply(code, payload, ctype=ctype or "application/json")
        return True

    def _trace_id(self) -> Optional[str]:
        """The request's propagated trace id (``X-PIO-Trace``), if any."""
        tid = self.headers.get(TRACE_HEADER)
        return tid.strip() if tid else None

    def parse_request(self) -> bool:
        self._body_read = False
        return super().parse_request()

    def _reply(self, code: int, payload: Any,
               ctype: str = "application/json") -> None:
        body = (
            payload
            if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload).encode()
        )
        if not self._body_read:
            # a reply before the handler read the request body (a 401
            # from the access-key check, a 404 route) must still consume
            # it: on a keep-alive connection the unread bytes would be
            # parsed as the next request line (the ingest router pools
            # its connections to the workers)
            self._body()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in getattr(self, "extra_headers", ()):
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        self._body_read = True
        return self.rfile.read(n) if n else b""


class HTTPServerBase:
    """Mixin providing the bind/serve/background/stop lifecycle.

    Subclasses implement ``_make_handler()`` and expose ``host``/``port``
    attributes (port 0 -> ephemeral, re-read after bind).  Binding happens
    in the caller's thread so bind errors (port in use) surface as
    exceptions instead of hanging a background thread.
    """

    host: str
    port: int
    _httpd = None  # CappedThreadingHTTPServer | EventLoopHTTPServer

    def _make_handler(self):
        raise NotImplementedError

    bind_retries = 3  # MasterActor retries the spray bind 3x in the reference
    # per-server connection bound + metric label; subclasses override
    max_connections: int = DEFAULT_MAX_CONNECTIONS
    server_name: str = "serving"

    def _build_httpd(self):
        """The bound server object.  Default: the capped threading edge;
        ``EngineServer`` returns an ``EventLoopHTTPServer`` on its
        event-loop edge (same ``server_address``/``serve_forever``/
        ``shutdown``/``server_close`` surface, one lifecycle here)."""
        return CappedThreadingHTTPServer(
            (self.host, self.port), self._make_handler(),
            max_connections=self.max_connections,
            server_name=self.server_name,
        )

    def _bind(self) -> None:
        import errno
        import time

        retries = max(1, self.bind_retries)
        for attempt in range(retries):
            try:
                self._httpd = self._build_httpd()
                break
            except OSError as e:
                # only a busy port is transient (a stale server shutting
                # down); permission/addr errors fail immediately
                if e.errno != errno.EADDRINUSE or attempt + 1 >= retries:
                    raise
                time.sleep(1.0)
        self.port = self._httpd.server_address[1]

    _serving: bool = False

    def serve_forever(self) -> None:
        if self._httpd is None:
            self._bind()
        self._serving = True
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        self._bind()
        self._serving = True
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    # stop() runs from a request thread (POST /stop) and from its owner
    # at once: the first stops the server, the second waits for that
    _stop_lock = threading.Lock()

    def stop(self) -> None:
        with self._stop_lock:
            if self._httpd is None:
                return
            if self._serving:
                # shutdown() handshakes with the serve loop; calling it on
                # a bound-but-never-served server would block forever
                self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._serving = False
