"""The port's event-loop HTTP edge against the JAX package's.

The same raw request bytes go to the JAX ``EventLoopHTTPServer`` and
the port's, each with the same handler; the status lines, headers and
bodies that come back must be equal, for each case the reference's own
tests cover (keep-alive, a reply from another thread, a double respond,
the connection cap's 503, 400, 431, 411 and 500, a body split across
packets, port 0 and address-in-use).
"""

import json
import socket
import threading
import time

import pytest

from predictionio_tpu.server.eventloop import (
    EventLoopHTTPServer as JaxEventLoopHTTPServer,
)
from predictionio_tpu_torch.server.eventloop import EventLoopHTTPServer

KINDS = {"jax": JaxEventLoopHTTPServer, "torch": EventLoopHTTPServer}


def _echo_handler(req, respond):
    if req.method == "POST" and req.path.startswith("/echo"):
        respond(200, {
            "method": req.method,
            "path": req.path,
            "body": req.body.decode(),
            "ctype": req.header("content-type"),
        })
    elif req.method == "GET" and req.path == "/ping":
        respond(200, {"pong": True})
    else:
        respond(404, {"message": "not found"})


def _boot(kind, handler, **kw):
    srv = KINDS[kind](("127.0.0.1", 0), handler, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _both(handler, case, **kw):
    """``case(server)`` against a JAX and a port server with the same
    handler; returns ``{"jax": ..., "torch": ...}``."""
    out = {}
    for kind in KINDS:
        srv, t = _boot(kind, handler, **kw)
        try:
            out[kind] = case(srv)
        finally:
            _stop(srv, t)
    return out


def _connect(srv):
    s = socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                 timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _read_response(s, buf=b""):
    """One response off the socket: ``((status line, headers, body),
    bytes left over)``."""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            raise ConnectionError(f"closed mid-head after {buf!r}")
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("iso-8859-1").split("\r\n")
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    n = int(headers["Content-Length"])
    while len(rest) < n:
        chunk = s.recv(65536)
        if not chunk:
            raise ConnectionError("closed mid-body")
        rest += chunk
    return (lines[0], headers, rest[:n]), rest[n:]


def _exchange(raw: bytes):
    """Send ``raw`` on a fresh connection, read one response."""
    def case(srv):
        with _connect(srv) as s:
            s.sendall(raw)
            return _read_response(s)[0]
    return case


def _post(path: str, body: bytes, extra: str = "") -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n{extra}\r\n").encode() + body


def test_roundtrip_and_keepalive_equal():
    def case(srv):
        got = []
        with _connect(srv) as s:
            for i in range(20):
                s.sendall(_post(f"/echo?i={i}", json.dumps({"i": i}).encode()))
                r, left = _read_response(s)
                assert left == b""
                got.append(r)
            s.sendall(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
            got.append(_read_response(s)[0])
        return got

    out = _both(_echo_handler, case)
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0] == "HTTP/1.1 200 OK"
    assert json.loads(out["torch"][-1][2]) == {"pong": True}


def test_pipelined_requests_answer_in_order_equal():
    raw = b"".join(_post(f"/echo/{i}", b'{"k": %d}' % i) for i in range(5))

    def case(srv):
        with _connect(srv) as s:
            s.sendall(raw)
            got, left = [], b""
            for _ in range(5):
                r, left = _read_response(s, left)
                got.append(r)
            return got

    out = _both(_echo_handler, case)
    assert out["torch"] == out["jax"]
    assert [json.loads(b)["path"] for _, _, b in out["torch"]] == [
        f"/echo/{i}" for i in range(5)]


def test_response_from_another_thread_equal():
    def deferred_handler(req, respond):
        def later():
            time.sleep(0.05)
            respond(200, {"deferred": True, "path": req.path})

        threading.Thread(target=later, daemon=True).start()

    def case(srv):
        t0 = time.perf_counter()
        r = _exchange(_post("/x", b"{}"))(srv)
        assert time.perf_counter() - t0 >= 0.04
        return r

    out = _both(deferred_handler, case)
    assert out["torch"] == out["jax"]
    assert json.loads(out["torch"][2]) == {"deferred": True, "path": "/x"}


def test_double_respond_raises_equal():
    errs = {"jax": [], "torch": []}

    def case(srv):
        kind = "jax" if isinstance(srv, JaxEventLoopHTTPServer) else "torch"

        def handler(req, respond):
            respond(200, {"first": True})
            try:
                respond(200, {"second": True})
            except RuntimeError as e:
                errs[kind].append(str(e))

        srv.handler = handler
        r = _exchange(b"GET / HTTP/1.1\r\n\r\n")(srv)
        deadline = time.monotonic() + 5.0
        while not errs[kind] and time.monotonic() < deadline:
            time.sleep(0.01)
        return r

    out = _both(_echo_handler, case)
    assert out["torch"] == out["jax"]
    assert errs["torch"] == errs["jax"] == ["request already answered"]


def test_connection_cap_sheds_with_the_same_503():
    def case(srv):
        held = [_connect(srv), _connect(srv)]
        for s in held:
            s.sendall(b"GET /ping HTTP/1.1\r\n\r\n")
            _read_response(s)
        deadline = time.monotonic() + 5.0
        while True:
            # the refusal can race the request write: reconnect
            try:
                r = _exchange(b"GET /ping HTTP/1.1\r\n\r\n")(srv)
                break
            except (ConnectionError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        for s in held:
            s.close()
        return r

    out = _both(_echo_handler, case, max_connections=2)
    assert out["torch"] == out["jax"]
    status, headers, body = out["torch"]
    assert status == "HTTP/1.1 503 Service Unavailable"
    assert headers["Retry-After"] == "1"
    assert json.loads(body)["error"] == "TooManyConnections"


@pytest.mark.parametrize("raw,code", [
    (b"NOT A REQUEST\r\n\r\n", 400),
    (b"GET /ping HTTP/1.1\r\nno colon here\r\n\r\n", 400),
    (b"GET /ping HTTP/1.1\r\nContent-Length: many\r\n\r\n", 400),
    (b"POST /echo HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 411),
    (b"GET /ping HTTP/1.1\r\nX-Big: " + b"a" * 40000, 431),
], ids=["request-line", "header-line", "content-length", "chunked",
        "head-too-large"])
def test_malformed_requests_get_the_same_error(raw, code):
    out = _both(_echo_handler, _exchange(raw))
    assert out["torch"] == out["jax"]
    status, headers, _ = out["torch"]
    assert status.startswith(f"HTTP/1.1 {code} ")
    assert headers["Connection"] == "close"


def test_handler_exception_answers_the_same_500():
    def bad_handler(req, respond):
        raise ValueError("handler exploded")

    out = _both(bad_handler, _exchange(b"GET / HTTP/1.1\r\n\r\n"))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "HTTP/1.1 500 Internal Server Error"
    assert "exploded" in json.loads(out["torch"][2])["message"]


def test_split_body_across_packets_equal():
    body = json.dumps({"k": "v" * 500}).encode()

    def case(srv):
        with _connect(srv) as s:
            s.sendall(_post("/echo", body)[:-len(body)])
            for i in range(0, len(body), 97):
                s.sendall(body[i:i + 97])
                time.sleep(0.002)
            return _read_response(s)[0]

    out = _both(_echo_handler, case)
    assert out["torch"] == out["jax"]
    assert json.loads(out["torch"][2])["body"] == body.decode()


def test_ephemeral_port_and_addr_in_use_equal():
    for kind, cls in KINDS.items():
        srv, t = _boot(kind, _echo_handler)
        try:
            port = srv.server_address[1]
            assert port > 0
            for other in KINDS.values():
                with pytest.raises(OSError):
                    other(("127.0.0.1", port), _echo_handler)
        finally:
            _stop(srv, t)
