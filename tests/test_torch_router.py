"""The port's serving replica router against the JAX package's, on the CPU.

The cases of ``tests/test_router.py`` that touch neither fold-in nor
tenancy, each run against both packages' routers over the same kind of
in-process fake replicas (event-loop servers answering ``/queries.json``
and ``/``): round robin, a killed replica masked with zero failures, the
structured 503 when every replica is down, the health loop recovering a
replica, the status and metrics surface, the trace header forwarded,
deadline admission, and the supervisor's respawn and its backoff.  The
status codes and bodies of both routers must be equal.  Every router and
fake is stopped in ``finally``.
"""

import concurrent.futures
import http.client
import json
import threading
import time

import pytest

from predictionio_tpu.obs import (
    REPLICA_RESPAWNS_TOTAL as JAX_REPLICA_RESPAWNS_TOTAL,
)
from predictionio_tpu.server import router as jax_router
from predictionio_tpu_torch.obs import REPLICA_RESPAWNS_TOTAL
from predictionio_tpu_torch.server import router as port_router
from predictionio_tpu_torch.server.eventloop import EventLoopHTTPServer

PACKAGES = ("jax", "port")


class FakeReplica:
    """A minimal replica: ``POST /queries.json`` (counted, optionally
    slow) and ``GET /`` with its model fields."""

    def __init__(self, name: str, delay: float = 0.0):
        self.name = name
        self.queries = 0
        self.delay = delay
        self.traces = []
        self.srv = EventLoopHTTPServer(("127.0.0.1", 0), self._handle,
                                       name=f"fake-{name}")
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def port(self):
        return self.srv.server_address[1]

    def _handle(self, req, respond):
        if req.method == "POST" and req.path.startswith("/queries.json"):
            if self.delay:
                time.sleep(self.delay)
            self.queries += 1
            self.traces.append(req.header("x-pio-trace"))
            respond(200, {"replica": self.name})
        elif req.method == "GET" and req.path == "/":
            respond(200, {"status": "alive", "engineInstanceId": self.name,
                          "requestCount": self.queries,
                          "modelFreshnessSec": 100.0})
        else:
            respond(404, {"message": "not found"})

    def kill(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def _replica(pkg, name, port):
    if pkg == "jax":
        return jax_router.Replica(name, "127.0.0.1", port,
                                  breaker_reset_s=0.2)
    return port_router.Replica(name, "127.0.0.1", port)


def _router(pkg, replicas, health_interval_s=0.1, supervisor=None):
    if pkg == "jax":
        cfg = jax_router.RouterConfig(host="127.0.0.1", port=0,
                                      health_interval_s=health_interval_s,
                                      forward_timeout_s=5.0)
        r = jax_router.RouterServer(replicas, cfg, supervisor=supervisor)
    else:
        cfg = port_router.RouterConfig(host="127.0.0.1", port=0,
                                       health_interval_s=health_interval_s)
        r = port_router.RouterServer(replicas, cfg, supervisor=supervisor)
    r.start_background()
    return r


class Fleet:
    """One package's router in front of fresh fakes."""

    def __init__(self, pkg, names=("r0", "r1"), **kw):
        delay = kw.pop("delay", 0.0)
        self.fakes = [FakeReplica(n, delay) for n in names]
        self.router = _router(pkg, [_replica(pkg, f.name, f.port)
                                    for f in self.fakes], **kw)

    def close(self):
        self.router.stop()
        for f in self.fakes:
            try:
                f.kill()
            except OSError:
                pass


@pytest.fixture()
def fleets():
    made = []

    def make(pkg, **kw):
        made.append(Fleet(pkg, **kw))
        return made[-1]

    try:
        yield make
    finally:
        for f in made:
            f.close()


def _post(port, path, payload=b"{}", headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("POST", path, payload, headers={
            "Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        c.close()


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read().decode()
    finally:
        c.close()


def _wait(pred, timeout=5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_round_robin_spreads_load(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg)
        answers = [_post(f.router.port, "/queries.json") for _ in range(20)]
        got[pkg] = (answers, [x.queries for x in f.fakes])
    assert got["port"] == got["jax"]
    assert got["port"][1] == [10, 10]


def test_killed_replica_masked_with_zero_failures(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg)
        stop = threading.Event()
        results = []

        def client():
            while not stop.is_set():
                try:
                    results.append(_post(f.router.port, "/queries.json")[0])
                except Exception as e:  # a transport error is a failure
                    results.append(f"exc:{e}")

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(client) for _ in range(4)]
            time.sleep(0.3)
            f.fakes[0].kill()  # mid-load, no warning
            time.sleep(0.7)
            stop.set()
            for fut in futs:
                fut.result(10)
        snap = f.router.status_json()
        by = {r["name"]: r for r in snap["replicas"]}
        # whether a forward or the health loop finds the death first is
        # timing: r0's failovers are not compared
        got[pkg] = (set(results), by["r0"]["healthy"], by["r1"]["healthy"],
                    snap["healthyReplicas"], by["r1"]["failovers"],
                    len(results) > 20)
    assert got["port"] == got["jax"] == ({200}, False, True, 1, 0, True)


def test_all_replicas_down_gives_structured_503(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg, names=("solo",), health_interval_s=30.0)
        first = _post(f.router.port, "/queries.json")
        f.fakes[0].kill()
        assert _wait(lambda: _post(f.router.port, "/queries.json")[0] == 503)
        status, body = _post(f.router.port, "/queries.json")
        got[pkg] = (first, status, body["error"],
                    body["message"].startswith("no replica available (solo:"))
    assert got["port"] == got["jax"] == (
        (200, {"replica": "solo"}), 503, "NoReplicaAvailable", True)


def test_health_loop_recovers_a_returned_replica(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg)
        f.fakes[1].kill()
        for _ in range(6):
            _post(f.router.port, "/queries.json")

        def r1_healthy():
            return {r["name"]: r for r in f.router.status_json()[
                "replicas"]}["r1"]["healthy"]

        down = _wait(lambda: not r1_healthy())
        revived = FakeReplica("r1b")
        f.fakes.append(revived)
        f.router.replicas[1].port = revived.port
        up = _wait(r1_healthy)
        snap = {r["name"]: r for r in f.router.status_json()["replicas"]}
        got[pkg] = (down, up, snap["r1"]["engineInstanceId"],
                    snap["r1"]["modelFreshnessSec"])
    assert got["port"] == got["jax"] == (True, True, "r1b", 100.0)


def test_router_status_and_metrics_surface(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg)
        for _ in range(4):
            _post(f.router.port, "/queries.json")
        assert _wait(lambda: all("modelFreshnessSec" in r for r in
                                 f.router.status_json()["replicas"]))
        code, text = _get(f.router.port, "/")
        snap = json.loads(text)
        mcode, metrics = _get(f.router.port, "/metrics")
        got[pkg] = (
            code, snap["role"], snap["requestCount"],
            # a scrape error shows once a sweep has scraped (the fakes
            # have no /metrics): the key is there or not by timing
            sorted(set(snap["replicas"][0]) - {"scrapeErrors"}),
            [(r["healthy"], r["forwarded"], r["engineInstanceId"])
             for r in snap["replicas"]],
            mcode,
            'pio_replica_up{replica="r0"} 1' in metrics,
            "pio_replica_model_freshness_seconds" in metrics,
            'pio_replica_requests_total{outcome="ok",replica="r0"}'
            in metrics or 'replica="r0",outcome="ok"' in metrics,
            "pio_router_forward_seconds_count" in metrics,
            "pio_router_segment_seconds" in metrics,
        )
        fcode, fleet_body = _get(f.router.port, "/debug/fleet")
        payload = json.loads(fleet_body)
        assert fcode == 200 and payload["role"] == "router"
        assert [r["name"] for r in payload["replicas"]] == ["r0", "r1"]
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (200, "router", 4)
    assert all(got["port"][5:])


def test_trace_header_forwarded(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg)
        status, _ = _post(f.router.port, "/queries.json",
                          headers={"X-PIO-Trace": "t-route-1"})
        _post(f.router.port, "/queries.json")  # the router mints one
        traces = f.fakes[0].traces + f.fakes[1].traces
        got[pkg] = (status, "t-route-1" in traces, len(traces),
                    all(traces))
    assert got["port"] == got["jax"] == (200, True, 2, True)


def test_router_deadline_admission_sheds_doomed_requests(fleets):
    got = {}
    for pkg in PACKAGES:
        f = fleets(pkg, names=("slow",), delay=0.15)
        warm = [_post(f.router.port, "/queries.json")[0] for _ in range(3)]
        served = f.fakes[0].queries
        assert f.router._ewma_forward.value > 0.1
        status, body = _post(f.router.port, "/queries.json?timeout=0.01")
        shed = (status, body["error"], f.fakes[0].queries == served)
        ok = _post(f.router.port, "/queries.json?timeout=30")[0]
        got[pkg] = (warm, shed, ok, f.fakes[0].queries - served,
                    f.router.status_json()["admissionRejected"])
    assert got["port"] == got["jax"] == (
        [200] * 3, (503, "AdmissionRejected", True), 200, 1, 1)


class _FakeProc:
    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc


def _respawn_walk(pkg, tmp_path, monkeypatch) -> tuple:
    """Kill a replica's process and listener: the supervisor respawns it
    on a new port, the router reaches the respawn, the counter books it,
    and the backoff resets once the respawn is healthy."""
    fakes = [FakeReplica("r0")]
    procs = [_FakeProc()]
    coord = tmp_path / pkg
    coord.mkdir()

    def spawner(index):
        fakes.append(FakeReplica(f"r0-respawn{len(fakes)}"))
        procs.append(_FakeProc())
        port_file = coord / f"respawn-{len(fakes)}.port"
        port_file.write_text(f"{fakes[-1].port}\n")
        return {"proc": procs[-1], "index": index, "port_file": port_file,
                "log_path": coord / "log", "_fake": fakes[-1]}

    if pkg == "jax":
        sup = jax_router.ReplicaSupervisor(
            spawner, waiter=lambda s, timeout_s=0.0: s["_fake"].port,
            backoff_base_s=0.05, backoff_cap_s=0.4)
        counter = JAX_REPLICA_RESPAWNS_TOTAL
    else:
        monkeypatch.setattr(port_router, "_BACKOFF_BASE_S", 0.05)
        monkeypatch.setattr(port_router, "_BACKOFF_CAP_S", 0.4)
        sup = port_router.ReplicaSupervisor(spawner)
        counter = REPLICA_RESPAWNS_TOTAL
    replica = _replica(pkg, "r0", fakes[0].port)
    sup.attach(replica, {"proc": procs[0], "index": 0,
                         "port_file": None, "log_path": None})
    router = _router(pkg, [replica], health_interval_s=0.05, supervisor=sup)
    try:
        first = _post(router.port, "/queries.json")[0]
        before = counter.labels(replica="r0").value()
        procs[0].rc = 137
        fakes[0].kill()
        back = _wait(lambda: sup.respawns >= 1 and replica.healthy, 10.0)
        after = _post(router.port, "/queries.json")
        st = sup._procs["r0"]
        return (first, back, counter.labels(replica="r0").value() - before,
                after[0], after[1]["replica"].startswith("r0-respawn"),
                replica.port != fakes[0].port,
                router.status_json()["supervisor"]["respawns"] >= 1,
                st["next_try"] > 0.0, st["attempts"])
    finally:
        router.stop()
        for f in fakes[1:]:
            f.kill()


def test_supervisor_respawns_a_dead_replica_with_backoff(tmp_path,
                                                         monkeypatch):
    got = {pkg: _respawn_walk(pkg, tmp_path, monkeypatch)
           for pkg in PACKAGES}
    assert got["port"] == got["jax"] == (
        200, True, 1, 200, True, True, True, True, 0)


def test_supervisor_failed_respawn_backs_off(monkeypatch):
    got = {}
    for pkg in PACKAGES:
        calls = []

        def spawner(index):
            calls.append(time.monotonic())
            raise RuntimeError("spawn exploded")

        if pkg == "jax":
            sup = jax_router.ReplicaSupervisor(
                spawner, waiter=lambda s, timeout_s=0: 0,
                backoff_base_s=0.05, backoff_cap_s=0.2)
        else:
            monkeypatch.setattr(port_router, "_BACKOFF_BASE_S", 0.05)
            monkeypatch.setattr(port_router, "_BACKOFF_CAP_S", 0.2)
            sup = port_router.ReplicaSupervisor(spawner)
        fake = FakeReplica("rX")
        replica = _replica(pkg, "rX", fake.port)
        dead = _FakeProc()
        dead.rc = 1
        sup.attach(replica, {"proc": dead, "index": 0,
                             "port_file": None, "log_path": None})
        try:
            for _ in range(50):
                sup.tick([replica])
                time.sleep(0.02)
            st = sup._procs["rX"]
            # a 1 s window at 20 ms ticks would try 50 times unthrottled
            got[pkg] = (1 <= len(calls) <= 12, sup.respawns,
                        st["attempts"] >= 2)
        finally:
            fake.kill()
    assert got["port"] == got["jax"] == (True, 0, True)


def test_unported_routes_name_their_item(fleets):
    """No route of the reference's router is left unported: the tenancy
    routes reach the replicas (tests/test_torch_tenancy_router.py holds
    them against the reference), and only an unknown route answers a
    plain 404."""
    f = fleets("port")
    status, body = _post(f.router.port, "/admin/tenants/weights",
                         b'{"app": "shop", "weights": {"a": 1}}')
    assert status == 200 and [p["replica"] for p in body["pushed"]] == [
        "r0", "r1"]
    status, body = _post(f.router.port, "/admin/tenants",
                         b'{"action": "remove", "app": "shop"}')
    assert status == 200 and len(body["pushed"]) == 2
    status, text = _get(f.router.port, "/debug/tenants")
    assert status == 200 and sorted(json.loads(text)["replicas"]) == [
        "r0", "r1"]
    for method, path in (("POST", "/admin/nothing"), ("GET", "/nothing")):
        if method == "POST":
            status, body = _post(f.router.port, path)
        else:
            status, text = _get(f.router.port, path)
            body = json.loads(text)
        assert (status, body) == (404, {"message": "not found"})
