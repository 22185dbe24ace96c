"""The port's multi-tenant engine server against the JAX package's.

Two apps x two variants at rank 8: the JAX package trains the four
instances from seeded rate events, the port gets the same events, the
same instances and their models (``convert.model_from_jax``), and each
package boots an ``EngineServer`` with a ``TenantRegistry`` built from
its own tenants.json by its console's ``_build_tenant_registry`` (the
anchor alpha/control, the rest loaded lazily through the server's
loader), on the event-loop edge and the threads edge.  Over HTTP:

* replies agree within 1e-4 of their scale with the same items, and
  every query (by app, appId, accessKey, explicit or assigned variant,
  none) lands on the same variant;
* ``/debug/tenants``, ``/debug/experiments`` and the status JSON's
  ``tenancy`` block are equal apart from times and bytes;
* ``POST /tenants/weights`` and ``POST /admin/tenants`` add/remove give
  equal replies, and the added tenant serves alike;
* a quota answers the same 429s and a ``tenant.dispatch`` fault plan the
  same 500s then 503s, the sibling serving throughout;
* ``OnlineEval`` over the same impressions and conversion events gives
  equal snapshots;
* on the event-loop edge, a resident tenant is answered in under 200 ms
  while another tenant loads for a second, and the loading tenant's
  query gets the reference's reply.
"""

import argparse
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.cli.main import (
    _build_tenant_registry as jax_build_tenant_registry,
    load_engine_from_variant as jax_load_engine_from_variant,
)
from predictionio_tpu.controller.base import (
    WorkflowContext as JaxWorkflowContext,
)
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.server.serving import (
    EngineServer as JaxEngineServer,
    ServerConfig as JaxServerConfig,
)
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.workflow.train import (
    prepare_deploy as jax_prepare_deploy,
    run_train as jax_run_train,
)
from predictionio_tpu_torch.cli.main import (
    _build_tenant_registry,
    load_engine_from_variant,
)
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.server import EngineServer, ServerConfig
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.metadata import AccessKey, EngineInstance
from predictionio_tpu_torch.workflow.model_io import save_models

FACTORY = {
    "jax": "predictionio_tpu.templates.recommendation.recommendation_engine",
    "port": ("predictionio_tpu_torch.templates.recommendation."
             "recommendation_engine"),
}
TENANTS = (("alpha", "control", 0.05), ("alpha", "treatment", 0.2),
           ("beta", "control", 0.1), ("beta", "treatment", 0.3))
KEYS = {"alpha": "KEY-ALPHA-" + "a" * 20, "beta": "KEY-BETA-" + "b" * 20}
N_USERS, N_ITEMS = 14, 12


class Homes:
    """Both packages' homes: the same apps, access keys and rate events,
    the four instances the JAX package trained (the port's a copy with
    its model carried over), an engine.json and a tenants.json each."""

    def __init__(self, root):
        self.storage = {
            "jax": JaxStorage({"PIO_TPU_HOME": str(root / "jax")}),
            "port": Storage({"PIO_TPU_HOME": str(root / "port")}),
        }
        keys = {"jax": JaxAccessKey, "port": AccessKey}
        self.app_ids = {}
        for n, st in self.storage.items():
            md = st.get_metadata()
            for app in ("alpha", "beta"):
                rec = md.app_insert(app)
                st.get_event_store().init_channel(rec.id)
                md.access_key_insert(keys[n](key=KEYS[app], appid=rec.id))
                self.app_ids[app] = rec.id
        rng = np.random.default_rng(11)
        for app in ("alpha", "beta"):
            self.rate(app, [
                (f"u{u}", f"i{i}", float(rng.integers(1, 11) * 0.5))
                for u in range(N_USERS)
                for i in rng.choice(N_ITEMS, 6, replace=False)])
        self.manifest = {}
        entries = {"jax": [], "port": []}
        for app, variant, lam in TENANTS:
            paths = {}
            for n in self.storage:
                p = root / n / f"{app}-{variant}.json"
                p.write_text(json.dumps({
                    "id": "hive-test", "engineFactory": FACTORY[n],
                    "datasource": {"params": {"appName": app}},
                    "algorithms": [{"name": "als", "params": {
                        "rank": 8, "numIterations": 3, "lambda": lam,
                        "seed": 1}}]}))
                paths[n] = str(p)
                entries[n].append({"app": app, "variant": variant,
                                   "engineJson": str(p), "weight": 0.5})
            self._train(paths)
        for n in self.storage:
            # beta/treatment's instance again, under a quota, and never
            # assigned (weight 0): only an explicit variant reaches it
            entries[n].append({"app": "beta", "variant": "limited",
                               "engineJson": entries[n][-1]["engineJson"],
                               "weight": 0.0, "quotaQps": 0.01,
                               "quotaBurst": 2})
        for n, st in self.storage.items():
            p = root / n / "tenants.json"
            p.write_text(json.dumps({"experimentSalt": "hive-test",
                                     "evalIntervalSec": 3600,
                                     "tenants": entries[n]}))
            self.manifest[n] = str(p)

    def _train(self, paths: dict) -> None:
        jst, pst = self.storage["jax"], self.storage["port"]
        engine, ep, variant = jax_load_engine_from_variant(paths["jax"])
        iid = jax_run_train(engine, ep, ctx=JaxWorkflowContext(storage=jst),
                            engine_id=variant["id"],
                            engine_variant=paths["jax"])
        rec = jst.get_metadata().engine_instance_get(iid)
        (jmodel,) = jax_prepare_deploy(
            engine, engine.params_from_instance(rec), iid,
            JaxWorkflowContext(storage=jst, mode="Serving"))
        pst.get_metadata().engine_instance_insert(dataclasses.replace(
            EngineInstance(**dataclasses.asdict(rec)),
            engine_variant=paths["port"]))
        pengine, pep, _ = load_engine_from_variant(paths["port"])
        (algo,) = pengine._algorithms(pengine.params_from_instance(rec))
        save_models(WorkflowContext(device="cpu", storage=pst), iid,
                    [("als", algo, model_from_jax(jmodel, "cpu"))])

    def rate(self, app: str, triples) -> None:
        for n, ev in (("jax", JaxEvent), ("port", Event)):
            self.storage[n].get_event_store().insert_batch([ev(
                event="rate", entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties={"rating": r}) for u, i, r in triples],
                self.app_ids[app])

    def events(self, app: str, rows) -> None:
        """The same events (``(event, entity, properties)``) into both
        stores."""
        for n, ev in (("jax", JaxEvent), ("port", Event)):
            self.storage[n].get_event_store().insert_batch([ev(
                event=e, entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id="i1",
                properties=props) for e, u, props in rows],
                self.app_ids[app])


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    h = Homes(tmp_path_factory.mktemp("hive"))
    yield h
    for st in h.storage.values():
        st.close()


class Servers:
    """Each package's multi-tenant server on ``edge``."""

    def __init__(self, homes: Homes, edge: str):
        self.homes = homes
        self.servers, self.regs = {}, {}
        makers = {
            "jax": (jax_build_tenant_registry, jax_load_engine_from_variant,
                    JaxEngineServer, JaxServerConfig,
                    lambda st: JaxWorkflowContext(storage=st,
                                                  mode="Serving")),
            "port": (_build_tenant_registry, load_engine_from_variant,
                     EngineServer, ServerConfig,
                     lambda st: WorkflowContext(device="cpu", storage=st,
                                                mode="Serving")),
        }
        for n, (build, load, server, config, ctx) in makers.items():
            st = homes.storage[n]
            reg = build(argparse.Namespace(multi=homes.manifest[n],
                                           memory_budget=None,
                                           autopilot=None), st)
            anchor = reg.spec(reg.anchor_key)
            engine, ep, variant = load(anchor.engine_json)
            iid = st.get_metadata().engine_instance_get_latest_completed(
                variant["id"], "1", anchor.engine_json).id
            srv = server(engine, ep, iid, ctx=ctx(st), config=config(
                port=0, edge=edge, microbatch_max=4, breaker_failures=3,
                breaker_reset_s=60.0), engine_id=variant["id"],
                engine_variant=anchor.engine_json, tenants=reg)
            srv.start_background()
            self.servers[n], self.regs[n] = srv, reg

    def each(self, fn) -> dict:
        return {n: fn(n) for n in self.servers}

    def call(self, method: str, path: str, body=None) -> dict:
        """The same request to both servers: ``{pkg: (code, json)}``; a
        callable ``body`` gives each package its own."""
        def one(n):
            doc = body(n) if callable(body) else body
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.servers[n].port}{path}",
                data=None if doc is None else json.dumps(doc).encode(),
                method=method, headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        return self.each(one)

    def close(self) -> None:
        for srv in self.servers.values():
            srv.stop()


@pytest.fixture(params=["eventloop", "threads"])
def servers(request, homes):
    s = Servers(homes, request.param)
    yield s
    s.close()


def _close_replies(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert got.get("variant") == want.get("variant")
    assert [s["item"] for s in got["itemScores"]] == [
        s["item"] for s in want["itemScores"]]
    g = np.array([s["score"] for s in got["itemScores"]], np.float64)
    w = np.array([s["score"] for s in want["itemScores"]], np.float64)
    scale = max(1.0, float(np.abs(w).max(initial=0.0)))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale)


def _queries() -> list:
    out = [{"user": f"u{u}", "num": 4, "app": app}
           for app in ("alpha", "beta") for u in range(N_USERS)]
    out += [{"user": "u3", "num": 3, "app": "alpha", "variant": v}
            for v in ("control", "treatment")]
    out += [{"user": "u5", "num": 2, "appId": "beta"},
            {"user": "u6", "num": 5, "accessKey": KEYS["beta"]},
            {"user": "u7", "num": 3},
            {"user": "stranger", "num": 3, "app": "beta"}]
    return out


def _without(doc, keys=("modelFreshnessSec", "residentBytes",
                        "deviceMemory", "startedAt", "placementBalance")):
    if isinstance(doc, dict):
        return {k: _without(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [_without(v, keys) for v in doc]
    return doc


def test_replies_and_variants_equal(servers):
    seen = set()
    for q in _queries():
        got = servers.call("POST", "/queries.json", q)
        assert got["port"][0] == got["jax"][0] == 200, (q, got)
        _close_replies(got["port"][1], got["jax"][1])
        seen.add((q.get("app"), got["port"][1]["variant"]))
    # both variants of both apps were assigned
    assert {("alpha", "control"), ("alpha", "treatment"),
            ("beta", "control"), ("beta", "treatment")} <= seen
    for bad in ({"user": "u1", "app": "ghost"},
                {"user": "u1", "app": "alpha", "variant": "nope"},
                {"user": "u1", "accessKey": "WRONG"}):
        got = servers.call("POST", "/queries.json", bad)
        assert got["port"] == got["jax"] and got["port"][0] == 400


def test_debug_and_status_equal(servers):
    for q in _queries()[:20]:
        servers.call("POST", "/queries.json", q)
    dbg = servers.call("GET", "/debug/tenants")
    assert dbg["port"][0] == dbg["jax"][0] == 200
    assert _without(dbg["port"][1]) == _without(dbg["jax"][1])
    assert dbg["port"][1]["resident"] == 4  # all but beta/limited
    assert dbg["port"][1]["residentBytes"] > 0
    exp = servers.call("GET", "/debug/experiments")
    assert exp["port"] == exp["jax"]
    assert exp["port"][1]["enabled"] is False
    status = servers.call("GET", "/")
    assert _without(status["port"][1]["tenancy"]) == _without(
        status["jax"][1]["tenancy"])


def test_weights_and_admin_routes_equal(servers, homes):
    bodies = [
        {"app": "alpha", "weights": {"control": 0.2, "treatment": 0.8}},
        {"app": "alpha", "weights": {"ghost": 1.0}},
        {"app": "ghost", "weights": {"a": 1.0}},
        {"app": "alpha", "weights": {"control": -1}},
        {"app": "alpha"},
    ]
    for body in bodies:
        got = servers.call("POST", "/tenants/weights", body)
        assert got["port"] == got["jax"], body
    assert got["port"][0] == 400
    # the new weights route users alike
    for u in range(N_USERS):
        got = servers.call("POST", "/queries.json",
                           {"user": f"u{u}", "num": 2, "app": "alpha"})
        assert got["port"][1]["variant"] == got["jax"][1]["variant"]

    def add(n):
        return {"action": "add", "tenant": {
            "app": "alpha", "variant": "extra", "weight": 1.0,
            "engineJson": json.load(open(homes.manifest[n]))[
                "tenants"][1]["engineJson"]}}

    added = servers.call("POST", "/admin/tenants", add)
    assert added["port"] == added["jax"]
    assert added["port"][1]["added"] == "alpha/extra"
    got = servers.call("POST", "/queries.json",
                       {"user": "u2", "num": 3, "app": "alpha",
                        "variant": "extra"})
    _close_replies(got["port"][1], got["jax"][1])
    again = servers.call("POST", "/admin/tenants", add)
    assert again["port"] == again["jax"] and again["port"][0] == 400
    for body in ({"action": "remove", "app": "alpha", "variant": "extra"},
                 {"action": "remove", "app": "alpha", "variant": "extra"},
                 {"action": "remove", "app": "alpha", "variant": "control"},
                 {"action": "remove"}, {"action": "rename"},
                 {"action": "add", "tenant": {"app": "x"}}):
        got = servers.call("POST", "/admin/tenants", body)
        assert got["port"] == got["jax"], body
    dbg = servers.call("GET", "/debug/tenants")
    assert _without(dbg["port"][1]) == _without(dbg["jax"][1])


def test_quota_and_breaker_replies_equal(servers):
    quota = [servers.call("POST", "/queries.json", {
        "user": "u1", "num": 2, "app": "beta", "variant": "limited"})
        for _ in range(4)]
    codes = [(q["port"][0], q["jax"][0]) for q in quota]
    assert codes == [(200, 200), (200, 200), (429, 429), (429, 429)]
    assert quota[-1]["port"][1] == quota[-1]["jax"][1]
    assert quota[-1]["port"][1]["error"] == "QuotaExceeded"
    # the sibling is unaffected
    sib = servers.call("POST", "/queries.json", {
        "user": "u1", "num": 2, "app": "beta", "variant": "treatment"})
    assert sib["port"][0] == sib["jax"][0] == 200
    plan = "tenant.dispatch:tenant=alpha/treatment,exc=fault"
    faults.arm(plan)
    jax_faults.arm(plan)
    try:
        got = []
        for k in range(6):
            broken = servers.call("POST", "/queries.json", {
                "user": f"u{k}", "num": 2, "app": "alpha",
                "variant": "treatment"})
            fine = servers.call("POST", "/queries.json", {
                "user": f"u{k}", "num": 2, "app": "alpha",
                "variant": "control"})
            assert fine["port"][0] == fine["jax"][0] == 200
            got.append((broken["port"][0], broken["jax"][0]))
            assert (broken["port"][1].get("error")
                    == broken["jax"][1].get("error"))
    finally:
        faults.disarm()
        jax_faults.disarm()
    assert got == [(500, 500)] * 3 + [(503, 503)] * 3
    assert broken["port"][1]["error"] == "TenantUnavailable"
    breaker = servers.call("GET", "/debug/tenants")
    assert (breaker["port"][1]["resident_tenants"]["alpha/treatment"]
            ["breaker"]) == "open"


def test_online_eval_refresh_equal(servers, homes):
    for q in _queries():
        servers.call("POST", "/queries.json", q)
    rng = np.random.default_rng(4)
    for app in ("alpha", "beta"):
        rows = [("click", f"u{k}", {"variant": str(rng.choice(
            ["control", "treatment"]))}) for k in range(12)]
        rows += [("predict", "p1", {"variant": "control"}),
                 ("buy", "u2", {"other": 1})]
        homes.events(app, rows)
    snaps = servers.each(lambda n: servers.regs[n].refresh_online_eval(
        homes.storage[n].get_event_store()))
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["alpha/control"]["impressions"] > 0
    assert sum(c["conversions"] for c in snaps["port"].values()) >= 24
    again = servers.each(lambda n: servers.regs[n].refresh_online_eval(
        homes.storage[n].get_event_store()))
    assert again["port"] == again["jax"] == {
        k: v for k, v in snaps["port"].items()}


def _post_port(servers, doc) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{servers.servers['port'].port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_a_lazy_load_leaves_the_loop_answering(homes, monkeypatch):
    servers = Servers(homes, "eventloop")
    try:
        reg = servers.regs["port"]
        loader = reg.loader

        def slow(spec):
            time.sleep(1.0)
            return loader(spec)

        monkeypatch.setattr(reg, "loader", slow)
        resident = {"user": "u1", "num": 4, "app": "alpha",
                    "variant": "control"}
        assert _post_port(servers, resident)[0] == 200
        lazy = {"user": "u2", "num": 4, "app": "beta", "variant": "control"}
        got = {}
        loading = threading.Thread(
            target=lambda: got.update(port=_post_port(servers, lazy)))
        loading.start()
        time.sleep(0.2)
        waits = []
        for u in range(5):
            t0 = time.perf_counter()
            code, _ = _post_port(servers, {**resident, "user": f"u{u}"})
            waits.append(time.perf_counter() - t0)
            assert code == 200
        still_loading = loading.is_alive()
        loading.join(30)
        assert not loading.is_alive()
        assert max(waits) < 0.2, waits
        assert still_loading
        want = servers.call("POST", "/queries.json", lazy)["jax"]
        assert got["port"][0] == want[0] == 200
        _close_replies(got["port"][1], want[1])
    finally:
        servers.close()
