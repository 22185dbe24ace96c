"""The port's event-loop edge writes a reply completed off the loop
from the completing thread, against the JAX package's edge, which hands
every such reply to its loop thread: the same bytes on the wire, in
request order, and the same fate for a reply whose client left.
"""

import json
import socket
import threading
import time

from predictionio_tpu_torch.obs.timeline import Timeline
from test_torch_eventloop import _both, _connect, _post, _read_response


def test_off_loop_reply_is_written_by_its_own_thread():
    """A reply completed off the loop: the port's completing thread
    writes it and finishes its timeline before ``respond`` returns,
    while a reply too large for the socket's buffer leaves its rest, and
    its timeline, to the loop.  Pipelined requests behind such replies
    still answer in order, with the reference's bytes, and every
    timeline is finished."""
    timelines = {}

    def deferred_handler(req, respond):
        def later():
            # a family without histograms: finish() books nothing
            tl = Timeline("test")
            pad = "x" * (32 << 20 if req.path == "/big" else 8)
            respond(200, {"path": req.path, "pad": pad}, tl=tl)
            timelines[req.path] = (tl, "write" in tl.segments)

        threading.Thread(target=later, daemon=True).start()

    # the large reply last: a small one behind it could meet a full
    # send buffer
    paths = ["/a", "/b", "/c", "/big"]
    raw = b"".join(_post(p, b"{}") for p in paths)

    def case(srv):
        timelines.clear()
        with _connect(srv) as s:
            s.sendall(raw)
            got, left = [], b""
            for _ in paths:
                r, left = _read_response(s, left)
                got.append(r)
        deadline = time.monotonic() + 10
        while not all(p in timelines and "write" in timelines[p][0].segments
                      for p in paths):
            assert time.monotonic() < deadline, timelines
            time.sleep(0.01)
        return got, {p: timelines[p][1] for p in paths}

    out = _both(deferred_handler, case)
    assert out["torch"][0] == out["jax"][0]
    assert [json.loads(b)["path"] for _, _, b in out["torch"][0]] == paths
    # the port's completing thread wrote each small reply before its
    # respond returned (the reference's loop may or may not have by
    # then, and so may the port's for the large one's rest)
    assert all(out["torch"][1][p] for p in ("/a", "/b", "/c"))


def test_reply_to_a_departed_client_is_dropped_equal():
    """The client closes its connection before its deferred reply is
    ready: ``respond`` neither raises nor blocks, and the server goes on
    answering new connections."""
    raised = []

    def deferred_handler(req, respond):
        def later():
            time.sleep(0.2)
            try:
                respond(200, {"path": req.path})
            except Exception as e:  # noqa: BLE001 - the test reports it
                raised.append(e)

        if req.path == "/ping":
            respond(200, {"pong": True})
        else:
            threading.Thread(target=later, daemon=True).start()

    def case(srv):
        raised.clear()
        s = _connect(srv)
        s.sendall(_post("/gone", b"{}"))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
        time.sleep(0.4)
        with _connect(srv) as s2:
            s2.sendall(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
            r = _read_response(s2)[0]
        return r, list(raised)

    out = _both(deferred_handler, case)
    assert out["torch"] == out["jax"]
    assert json.loads(out["torch"][0][2]) == {"pong": True}
    assert out["torch"][1] == []
