"""Selector-based event-loop HTTP edge.

Port of ``predictionio_tpu/server/eventloop.py``.  The threads edge
spends one OS thread per connection.  This edge is ONE loop thread that
multiplexes every connection through a ``selectors.DefaultSelector``: it
accepts, parses, enforces the connection cap, and hands complete
requests to a handler that must never block the loop (device work rides
the micro-batcher's dispatcher thread, blocking routes ride a small aux
pool; :func:`callback_scope` marks the functions that run on the loop).

Responses may complete on any thread: :class:`Responder` is handed to
the handler and may be called exactly once from wherever the work
finished.  An off-loop completion writes the rendered bytes to the
socket itself when nothing else is queued on the connection, so a reply
does not wait for the loop thread to take the interpreter lock; what
the socket does not take, and the connection's bookkeeping (the next
pipelined request, a close), go to the loop through a self-pipe.

The class exposes the ``server_address`` / ``serve_forever`` /
``shutdown`` / ``server_close`` surface of ``socketserver.BaseServer``,
so ``HTTPServerBase`` drives either edge through one lifecycle.

Not supported: chunked transfer encoding (411), TLS and HTTP/2.  The
edge books the reference's connection gauges (``HTTP_OPEN_CONNECTIONS``,
``HTTP_CONN_REJECTED``) and finishes each request's pulse timeline once
its response reached the socket.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import threading
import time
from typing import Callable, Optional

from ..obs import HTTP_CONN_REJECTED, HTTP_OPEN_CONNECTIONS

__all__ = [
    "EventLoopHTTPServer",
    "Request",
    "Responder",
    "callback_scope",
    "DEFAULT_MAX_CONNECTIONS",
]

logger = logging.getLogger(__name__)

DEFAULT_MAX_CONNECTIONS = 512
# a request head (request line + headers) larger than this is a client
# error or an attack; bounding it is half the slow-loris guard (the
# connection cap is the other half)
MAX_HEADER_BYTES = 32 * 1024
MAX_BODY_BYTES = 16 * 1024 * 1024
# keep-alive connections idle longer than this are closed on the next
# sweep so a silent client can't hold a cap slot forever
IDLE_TIMEOUT_S = 120.0


def callback_scope(fn):
    """Marker decorator for functions that run ON the event-loop thread
    (request handlers and completion callbacks).  Identity at run time:
    it documents that the function must not block (no sleep, no
    blocking socket I/O, no untimed queue get), because one blocked
    callback stalls every connection."""
    return fn


class Request:
    """One parsed HTTP request (headers lower-cased, body complete)."""

    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method: str, path: str, headers: dict, body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    def header(self, name: str, default: Optional[str] = None):
        return self.headers.get(name.lower(), default)


class Responder:
    """One-shot response channel for a single request.

    ``respond()`` is thread-safe; a second call raises, since a handler
    that answered twice has a logic bug worth surfacing.  ``tl`` (a pulse
    Timeline) is optional; when given, the loop marks the ``write``
    segment and finishes the timeline after the response bytes reach
    the socket, so the segments still sum to the covered wall time."""

    __slots__ = ("_server", "_conn", "_done", "_lock")

    def __init__(self, server: "EventLoopHTTPServer", conn: "_Conn"):
        self._server = server
        self._conn = conn
        self._done = False
        self._lock = threading.Lock()

    def __call__(self, code: int, payload,
                 ctype: str = "application/json",
                 extra_headers=(), tl=None, close: bool = False) -> None:
        with self._lock:
            if self._done:
                raise RuntimeError("request already answered")
            self._done = True
        body = (
            payload if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload).encode()
        )
        data = self._server._render(code, body, ctype, extra_headers, close)
        self._server._complete(self._conn, data, tl, close)


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 411: "Length Required",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    503: "Service Unavailable",
}


class _Conn:
    """Per-connection state: read buffer, parse state, write queue."""

    __slots__ = ("sock", "addr", "rbuf", "wbuf", "woff", "busy",
                 "closing", "tl", "last_activity", "need", "registered",
                 "wlock", "closed")

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.rbuf = bytearray()
        self.wbuf: list[bytes] = []
        self.woff = 0          # offset into wbuf[0]
        self.busy = False      # a request is in flight (handler owns it)
        self.closing = False   # close once wbuf drains
        self.last_activity = time.monotonic()
        self.need = None       # (request head, content-length) mid-body
        self.tl = None         # pulse timeline to finish after the write
        self.registered = selectors.EVENT_READ
        # held around every send and the close: an off-loop writer never
        # sends on a socket the loop closed (or on a reused descriptor)
        self.wlock = threading.Lock()
        self.closed = False


class EventLoopHTTPServer:
    """One selector loop serving many connections; see module doc."""

    def __init__(self, server_address, handler:
                 Callable[[Request, Responder], None],
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 name: str = "serving",
                 idle_timeout_s: float = IDLE_TIMEOUT_S):
        self.handler = handler
        self.name = name
        self.max_connections = max_connections
        self.idle_timeout_s = idle_timeout_s
        self._sel = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._lsock.bind(server_address)
            self._lsock.listen(min(max_connections, socket.SOMAXCONN))
        except BaseException:
            self._lsock.close()
            self._sel.close()
            raise
        self._lsock.setblocking(False)
        self.server_address = self._lsock.getsockname()
        # self-pipe: off-loop completions + shutdown wake the selector
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._conns: set[_Conn] = set()
        self._pending_lock = threading.Lock()
        self._pending: list[tuple[_Conn, bytes, object, bool]] = []
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._m_open = HTTP_OPEN_CONNECTIONS.labels(server=name)
        self._m_rejected = HTTP_CONN_REJECTED.labels(server=name)

    # -- BaseServer-compatible lifecycle -----------------------------------
    def serve_forever(self) -> None:
        from ..obs import scope

        # pio-scope: the loop thread's running share on /debug/pprof is
        # the single-core ceiling evidence
        scope.register_thread_role("eventloop")
        self._loop_thread = threading.current_thread()
        self._sel.register(self._lsock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        try:
            while not self._stop.is_set():
                events = self._sel.select(timeout=1.0)
                for key, mask in events:
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wakeups()
                    else:
                        conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._readable(conn)
                        if mask & selectors.EVENT_WRITE:
                            self._writable(conn)
                now = time.monotonic()
                if now - last_sweep >= 5.0:
                    last_sweep = now
                    self._sweep_idle(now)
        finally:
            self._stopped.set()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake()
        self._stopped.wait(10.0)

    def server_close(self) -> None:
        for conn in list(self._conns):
            self._close_conn(conn)
        for s in (self._lsock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        self._sel.close()

    # -- loop internals ----------------------------------------------------
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _drain_wakeups(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:  # BlockingIOError included: drained
            pass
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for conn, data, tl, close in pending:
            if conn in self._conns:
                conn.tl = tl
                conn.closing = conn.closing or close
                if data:
                    conn.wbuf.append(data)
                self._writable(conn)

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except OSError:  # BlockingIOError included: nothing pending
                return
            if len(self._conns) >= self.max_connections:
                # the structured overflow answer: a bounded edge sheds
                # load visibly instead of queueing sockets to die
                self._m_rejected.inc()
                self._refuse(sock)
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self._conns.add(conn)
            self._m_open.set(float(len(self._conns)))
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _refuse(self, sock: socket.socket) -> None:
        body = json.dumps({
            "message": "connection limit reached",
            "error": "TooManyConnections",
        }).encode()
        try:
            sock.setblocking(False)
            sock.send(
                b"HTTP/1.1 503 Service Unavailable\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Retry-After: 1\r\nConnection: close\r\n\r\n" + body
            )
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _sweep_idle(self, now: float) -> None:
        for conn in [c for c in self._conns
                     if not c.busy and not c.wbuf
                     and now - c.last_activity > self.idle_timeout_s]:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        self._m_open.set(float(len(self._conns)))
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        with conn.wlock:
            conn.closed = True
            try:
                conn.sock.close()
            except OSError:
                pass

    def _set_interest(self, conn: _Conn, events: int) -> None:
        if conn.registered == events or conn not in self._conns:
            return
        conn.registered = events
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not chunk:
            # peer closed; any in-flight response has nowhere to go
            self._close_conn(conn)
            return
        conn.last_activity = time.monotonic()
        conn.rbuf += chunk
        if len(conn.rbuf) > MAX_HEADER_BYTES and conn.need is None \
                and b"\r\n\r\n" not in conn.rbuf:
            self._error_close(conn, 431, "request head too large")
            return
        self._try_dispatch(conn)

    def _try_dispatch(self, conn: _Conn) -> None:
        """Parse and hand off at most ONE request; further pipelined
        bytes wait in rbuf until the response is written (responses go
        out in request order on a connection)."""
        if conn.busy or conn.closing:
            return
        if conn.need is None:
            end = conn.rbuf.find(b"\r\n\r\n")
            if end < 0:
                return
            head = bytes(conn.rbuf[:end])
            del conn.rbuf[:end + 4]
            try:
                req = self._parse_head(head)
            except ValueError as e:
                self._error_close(conn, 400, f"bad request: {e}")
                return
            if req.header("transfer-encoding"):
                self._error_close(
                    conn, 411, "chunked transfer encoding not supported"
                )
                return
            try:
                length = int(req.header("content-length", "0") or "0")
            except ValueError:
                self._error_close(conn, 400, "bad Content-Length")
                return
            if length < 0 or length > MAX_BODY_BYTES:
                self._error_close(conn, 400, "unacceptable Content-Length")
                return
            conn.need = (req, length)
        req, length = conn.need
        if len(conn.rbuf) < length:
            return
        req.body = bytes(conn.rbuf[:length])
        del conn.rbuf[:length]
        conn.need = None
        if req.header("connection", "").lower() == "close":
            conn.closing = True
        conn.busy = True
        responder = Responder(self, conn)
        try:
            self.handler(req, responder)
        except Exception as e:  # a crashed handler must still answer
            logger.exception("event-loop handler failed")
            try:
                responder(500, {"message": f"internal error: {e}"})
            except RuntimeError:
                pass  # the handler answered before raising

    @staticmethod
    def _parse_head(head: bytes) -> Request:
        text = head.decode("iso-8859-1")  # total: every byte decodes
        lines = text.split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise ValueError(f"malformed request line: {lines[0]!r}")
        method, path, _version = parts
        headers: dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, sep, v = ln.partition(":")
            if not sep:
                raise ValueError(f"malformed header line: {ln!r}")
            headers[k.strip().lower()] = v.strip()
        return Request(method, path, headers, b"")

    def _error_close(self, conn: _Conn, code: int, message: str) -> None:
        data = self._render(code, json.dumps({"message": message}).encode(),
                            "application/json", (), close=True)
        conn.closing = True
        conn.wbuf.append(data)
        self._writable(conn)

    def _render(self, code: int, body: bytes, ctype: str,
                extra_headers, close: bool) -> bytes:
        reason = _REASONS.get(code, "Unknown")
        out = [
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
        ]
        for k, v in extra_headers:
            out.append(f"{k}: {v}\r\n")
        if close:
            out.append("Connection: close\r\n")
        out.append("\r\n")
        return "".join(out).encode("iso-8859-1") + body

    def _complete(self, conn: _Conn, data: bytes, tl, close: bool) -> None:
        """Send or queue a rendered response; thread-safe (a Responder
        may fire from the batcher dispatcher or the aux pool).  Off the
        loop, the calling thread writes what the socket takes at once
        and finishes the timeline when that was all of it; the loop gets
        the rest and the connection's bookkeeping."""
        if threading.current_thread() is self._loop_thread:
            if conn in self._conns:
                conn.tl = tl
                conn.closing = conn.closing or close
                conn.wbuf.append(data)
                self._writable(conn)
            return
        sent = self._send_now(conn, data)
        if sent == len(data):
            data = b""
            if tl is not None:
                tl.mark("write")
                tl.finish()
                tl = None
        elif sent:
            data = data[sent:]
        with self._pending_lock:
            self._pending.append((conn, data, tl, close))
        self._wake()

    @staticmethod
    def _send_now(conn: _Conn, data: bytes) -> int:
        """Bytes of ``data`` written from the calling thread: none when
        the connection is closed, closing or has bytes queued (they go
        first), or when the socket fails (the loop then finds the
        fault)."""
        with conn.wlock:
            if conn.closed or conn.closing or conn.wbuf:
                return 0
            try:
                return conn.sock.send(data)
            except OSError:  # BlockingIOError included
                return 0

    def _writable(self, conn: _Conn) -> None:
        failed = False
        with conn.wlock:
            try:
                while conn.wbuf and not conn.closed:
                    buf = conn.wbuf[0]
                    n = conn.sock.send(
                        memoryview(buf)[conn.woff:] if conn.woff else buf
                    )
                    conn.woff += n
                    if conn.woff < len(buf):
                        break
                    conn.wbuf.pop(0)
                    conn.woff = 0
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                failed = True
        if failed:
            self._close_conn(conn)
            return
        if conn.wbuf:
            self._set_interest(
                conn, selectors.EVENT_READ | selectors.EVENT_WRITE
            )
            return
        # response fully flushed: close the request's timeline (the
        # write segment ends at the last successful send) and either
        # close the connection or look for the next pipelined request
        self._set_interest(conn, selectors.EVENT_READ)
        if conn.tl is not None:
            tl, conn.tl = conn.tl, None
            tl.mark("write")
            tl.finish()
        if conn.busy:
            conn.busy = False
            conn.last_activity = time.monotonic()
        if conn.closing:
            self._close_conn(conn)
        elif conn.rbuf:
            self._try_dispatch(conn)
