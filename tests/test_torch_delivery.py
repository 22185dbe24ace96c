"""The port's ``DeliveryQueue`` against the JAX package's, on the CPU.

Both packages' queues post to the same stub endpoint (each to a path of
its own) under the same conditions: the same fault plan and seed on the
queue's fault point (each package arms its own ``resilience.faults``), a
dead endpoint that opens the breaker and comes back, a queue over its
capacity, ``flush`` and ``close``.  Their ``stats()``, the bodies and
headers the endpoint received, the breaker's states and the
``pio_delivery_total`` deltas must be equal.  Every queue is closed, and
every plan disarmed, in ``finally``.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from predictionio_tpu.obs import DELIVERY_TOTAL as JAX_DELIVERY_TOTAL
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.resilience.delivery import (
    DeliveryQueue as JaxDeliveryQueue,
)
from predictionio_tpu.resilience.policy import (
    CircuitBreaker as JaxCircuitBreaker,
    RetryPolicy as JaxRetryPolicy,
)
from predictionio_tpu_torch.obs import DELIVERY_TOTAL
from predictionio_tpu_torch.resilience import (
    CircuitBreaker,
    DeliveryQueue,
    RetryPolicy,
    faults,
)

PACKAGES = {
    "jax": (JaxDeliveryQueue, JaxRetryPolicy, JaxCircuitBreaker,
            jax_faults, JAX_DELIVERY_TOTAL),
    "port": (DeliveryQueue, RetryPolicy, CircuitBreaker, faults,
             DELIVERY_TOTAL),
}
DEAD_URL = "http://127.0.0.1:1/never"


class Sink:
    """A stub endpoint: records each POST's path, body and trace header
    and answers 200 (or 500 while ``fail_next`` lasts)."""

    def __init__(self, port: int = 0):
        sink = self
        self.received = []
        self.fail_next = 0
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with sink._lock:
                    fail = sink.fail_next > 0
                    sink.fail_next -= fail
                    if not fail:
                        sink.received.append((
                            self.path, body,
                            self.headers.get("X-PIO-Trace")))
                self.send_response(500 if fail else 200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def url(self, name: str) -> str:
        return f"http://127.0.0.1:{self.port}/{name}"

    def bodies(self, name: str) -> list:
        return [(b, t) for p, b, t in self.received if p == f"/{name}"]

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@pytest.fixture()
def sink():
    s = Sink()
    try:
        yield s
    finally:
        s.stop()


@pytest.fixture()
def disarm():
    try:
        yield
    finally:
        jax_faults.disarm()
        faults.disarm()


# a queue's drain thread goes on retrying after close(), and the
# reference's backoff overflows past 646 attempts (its thread then dies):
# "never drop" is 600 attempts here
def _queue(name, qname, retries=3, capacity=64, failures=1000, reset=0.05,
           point=None):
    cls, retry, breaker = PACKAGES[name][:3]
    return cls(qname, capacity=capacity,
               retry=retry(max_attempts=retries, base_s=0.001, cap_s=0.005,
                           seed=0),
               breaker=breaker(failure_threshold=failures,
                               reset_timeout_s=reset),
               timeout_s=2.0, fault_point=point)


def _stats(q) -> dict:
    return {k: v for k, v in q.stats().items() if k != "breaker"}


def _wait(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _outcomes(name, qname) -> dict:
    fam = PACKAGES[name][4]
    return {k: fam.labels(queue=qname, outcome=k).value()
            for k in ("submitted", "delivered", "dropped", "retried")}


@pytest.mark.parametrize("point", ["http.feedback", "http.remote_log"])
def test_a_seeded_fault_plan_gives_equal_outcomes(sink, disarm, point):
    got = {}
    for name in PACKAGES:
        PACKAGES[name][3].arm(f"seed=7;{point}:prob=0.5")
        qname = f"plan-{point}-{name}"
        before = _outcomes(name, qname)
        q = _queue(name, qname, point=point)
        try:
            for k in range(40):
                q.submit(sink.url(name), {"k": k},
                         headers={"X-PIO-Trace": f"t{k}"})
            assert q.flush(30.0)
            after = _outcomes(name, qname)
            got[name] = (_stats(q), q.stats()["breaker"]["state"],
                         sink.bodies(name),
                         {k: after[k] - before[k] for k in after})
        finally:
            q.close()
    assert got["port"] == got["jax"]
    stats = got["port"][0]
    assert stats["delivered"] + stats["dropped"] == stats["submitted"] == 40
    assert 0 < stats["dropped"] < stats["delivered"]
    assert stats["retries"] > 0
    assert got["port"][3]["delivered"] == stats["delivered"]
    # each delivered body carries its own trace header
    assert len(got["port"][2]) == stats["delivered"]
    assert all(t == f"t{json.loads(b)['k']}" for b, t in got["port"][2])


def test_transient_failures_retry_to_one_delivery(sink):
    got = {}
    for name in PACKAGES:
        sink.fail_next = 2
        q = _queue(name, f"transient-{name}", retries=10)
        try:
            q.submit(sink.url(name), b"raw-bytes")
            assert q.flush(10.0)
            got[name] = (_stats(q), sink.bodies(name))
        finally:
            q.close()
    assert got["port"] == got["jax"]
    assert got["port"][0]["retries"] == 2 and got["port"][1] == [
        (b"raw-bytes", None)]


def _state_walk(name, port) -> tuple:
    """Submit five entries to a dead endpoint (breaker of 2 failures),
    wait for it to open, hold there, bring the endpoint back on the same
    port and flush; the states seen and the stats at each step."""
    q = _queue(name, f"breaker-{name}", retries=600, failures=2,
               reset=0.3)
    seen = [q.stats()["breaker"]["state"]]
    revived = None
    try:
        for k in range(5):
            q.submit(f"http://127.0.0.1:{port}/{name}", {"k": k})
        assert _wait(lambda: q.stats()["breaker"]["state"] == "open")
        seen.append("open")
        failures = q.stats()["sendFailures"]
        time.sleep(0.1)  # inside the reset window: no attempt is made
        held = (q.stats()["sendFailures"] == failures,
                q.stats()["depth"])
        revived = Sink(port)
        assert q.flush(15.0), q.stats()
        snap = q.stats()["breaker"]
        seen.append(snap["state"])
        out = (seen, held, snap["openCount"] >= 1,
               {k: v for k, v in _stats(q).items()
                if k not in ("retries", "sendFailures")},
               revived.bodies(name))
    finally:
        q.close()
        if revived is not None:
            revived.stop()
    return out


def test_the_breaker_opens_holds_and_closes_alike(sink):
    port = sink.port
    sink.stop()
    got = {name: _state_walk(name, port) for name in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["closed", "open", "closed"]
    assert got["port"][1] == (True, 5)
    assert got["port"][3]["delivered"] == 5
    assert [json.loads(b)["k"] for b, _ in got["port"][4]] == list(range(5))


def test_capacity_overflow_drops_the_oldest_alike():
    got = {}
    for name in PACKAGES:
        qname = f"overflow-{name}"
        before = _outcomes(name, qname)
        q = _queue(name, qname, retries=600, capacity=4)
        try:
            kept = [q.submit(DEAD_URL, {"i": i}) for i in range(10)]
            st = _stats(q)
            after = _outcomes(name, qname)
            got[name] = (kept, st["depth"], st["dropped"], st["submitted"],
                         st["capacity"], after["dropped"] - before["dropped"])
        finally:
            q.close()
    assert got["port"] == got["jax"] == (
        [True] * 4 + [False] * 6, 4, 6, 10, 4, 6)


def test_flush_and_close_answer_alike(sink):
    got = {}
    for name in PACKAGES:
        out = []
        q = _queue(name, f"close-{name}")
        dead = _queue(name, f"close-dead-{name}", retries=600)
        try:
            out.append(q.flush(1.0))  # empty: drained at once
            q.submit(sink.url(name), {"a": 1})
            out.append(q.flush(10.0))
            dead.submit(DEAD_URL, {"b": 2})
            out.append(dead.flush(0.2))  # the entry cannot drain
            q.close()
            out.append(q.submit(sink.url(name), {"late": 1}))
            out.append(_stats(q))
            dead.close()
            out.append(dead.stats()["depth"])
        finally:
            q.close()
            dead.close()
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][:4] == [True, True, False, False]
    assert got["port"][4]["dropped"] == 1 and got["port"][4]["delivered"] == 1
