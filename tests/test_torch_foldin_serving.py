"""Fold-in through the port's console and servers, on the CPU: the five
invariants of the reference's ``tools/foldin_smoke.py``.

An instance is trained through ``train`` (``solver="pallas"``, rank 4)
on a single-file or a 4-shard store and deployed through ``deploy`` on
either edge; ``foldin --watch --from-now --max-cycles N`` runs beside
it.  For a user the model has never seen: the reply is the empty
fallback (``cold_start_is_fallback``); a window of their ratings gives
a delta link that appends them (``foldin_produces_delta``); the server
applies it in place, by ``--foldin-poll`` or ``POST /foldin/apply``,
with no reload and the same instance, and its reply equals an
in-process ``predict`` on the model and the chain
(``serving_applies_without_reload``); the status JSON carries
``modelFreshnessSec`` and a zero ``foldinWatermarkLag`` and ``/metrics``
the fold-in families (``status_reports_freshness``); two more
same-shaped cycles add no solve signature
(``solver_signature_stable``).  ``deploy --replicas 2 --push-foldin``
and the router's ``POST /admin/push-foldin`` take a link to every
replica.  Every server and thread is stopped in ``finally``.

Against the reference, on both edges: the JAX package trains an
instance on seeded events, the port gets the same events and the same
instance (its model through ``convert.model_from_jax``), and each
package's ``FoldInRunner`` folds in the same new events from now.  The
cycles' counts and watermarks are equal, as are the router's
``/admin/push-foldin`` reply, ``POST /foldin/apply``'s reply and the
status JSON's fold-in fields (the freshness seconds apart), and every
reply through the routers agrees within 1e-4 of its scale.
"""

import dataclasses
import io
import json
import os
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from predictionio_tpu.controller.base import (
    WorkflowContext as JaxWorkflowContext,
)
from predictionio_tpu.live import FoldInRunner as JaxFoldInRunner
from predictionio_tpu.server import router as jax_router
from predictionio_tpu.server.serving import (
    EngineServer as JaxEngineServer,
    ServerConfig as JaxServerConfig,
)
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.workflow.train import (
    prepare_deploy as jax_prepare_deploy,
    run_train as jax_run_train,
)
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.live import FoldInRunner, FoldInSolver
from predictionio_tpu_torch.live.apply import apply_model_delta
from predictionio_tpu_torch.obs import fleet
from predictionio_tpu_torch.server import EngineServer, ServerConfig
from predictionio_tpu_torch.server import router as port_router
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.metadata import EngineInstance
from predictionio_tpu_torch.templates.recommendation import (
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import prepare_deploy_components
from predictionio_tpu_torch.workflow.model_io import (
    delta_file_name,
    load_model_delta_chain,
    model_key,
    save_models,
)

FACTORY = "predictionio_tpu_torch.templates.recommendation.recommendation_engine"
N_USERS, N_ITEMS = 16, 12


class Home:
    """A scratch ``$PIO_TPU_HOME`` (single-file or 4-shard event store)
    with an app of seeded ratings and one instance trained through the
    console."""

    def __init__(self, tmp_path, sharded: bool):
        self.env = {"PIO_TPU_HOME": str(tmp_path / "home")}
        if sharded:
            self.env.update({
                "PIO_STORAGE_SOURCES_SH_TYPE": "sqlite-sharded",
                "PIO_STORAGE_SOURCES_SH_PATH": str(tmp_path / "shards"),
                "PIO_STORAGE_SOURCES_SH_SHARDS": "4",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH",
            })
        self.storage = Storage(self.env)
        self.run("app", "new", "shop")
        self.es = self.storage.get_event_store()
        rng = np.random.default_rng(0)
        self.rate([(f"u{u}", f"i{i}", float(rng.integers(1, 6)))
                   for u in range(N_USERS)
                   for i in rng.choice(N_ITEMS, 6, replace=False)])
        self.engine_json = str(tmp_path / "engine.json")
        with open(self.engine_json, "w") as f:
            json.dump({
                "id": "foldin-test", "engineFactory": FACTORY,
                "datasource": {"params": {"appName": "shop"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 4, "numIterations": 3, "lambda": 0.1,
                    "seed": 1, "solver": "pallas"}}],
            }, f)
        out = self.run("train", "--engine-json", self.engine_json)
        self.iid = out.split()[-1]
        self.engine = recommendation_engine()
        with open(self.engine_json) as f:
            self.ep = self.engine.params_from_variant(json.load(f))

    def run(self, *argv) -> str:
        """The console in this process on the CPU; its stdout."""
        out = io.StringIO()
        with redirect_stdout(out):
            rc = main(list(argv), storage=self.storage, device="cpu")
        assert rc == 0, (argv, out.getvalue())
        return out.getvalue()

    def rate(self, triples) -> None:
        self.es.insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties={"rating": r}) for u, i, r in triples], 1)

    def in_thread(self, *argv) -> threading.Thread:
        t = threading.Thread(target=main, args=(list(argv),), kwargs=dict(
            storage=self.storage, device="cpu"), daemon=True)
        t.start()
        return t

    def predict_on_chain(self, user: str) -> dict:
        """In-process ``predict`` on the instance's model and every link
        of its delta chain."""
        ctx = WorkflowContext(device="cpu", storage=self.storage,
                              mode="Serving")
        algos, models, _ = prepare_deploy_components(
            self.engine, self.ep, self.iid, ctx=ctx)
        chain, err = load_model_delta_chain(
            self.storage.model_data_dir() / self.iid,
            model_key(self.iid, 0, "als"))
        assert err is None
        for d in chain:
            apply_model_delta(models[0], d)
        return algos[0].predict(models[0], Query(user=user, num=3)).to_json()


def _wait_port(path, timeout=120.0) -> int:
    deadline = time.monotonic() + timeout
    while not (os.path.exists(path) and open(path).read().endswith("\n")):
        assert time.monotonic() < deadline, "no port announced"
        time.sleep(0.05)
    return int(open(path).read())


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        text = r.read().decode()
    return text if path == "/metrics" else json.loads(text)


def _reloads(port: int) -> float:
    state = fleet.parse_prometheus(_get(port, "/metrics"))
    fam = state.get("pio_reloads_total", {})
    return sum(c["value"] for c in fam.get("children", []))


def _wait(pred, what: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _same_reply(got: dict, want: dict) -> None:
    assert [s["item"] for s in got["itemScores"]] == [
        s["item"] for s in want["itemScores"]]
    assert np.allclose([s["score"] for s in got["itemScores"]],
                       [s["score"] for s in want["itemScores"]],
                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("edge,sharded,trigger", [
    ("eventloop", True, "poll"),
    ("threads", False, "apply"),
    ("eventloop", False, "apply"),
])
def test_the_smoke_invariants_hold(tmp_path, edge, sharded, trigger):
    home = Home(tmp_path, sharded)
    pf = str(tmp_path / "port")
    argv = ["deploy", "--engine-json", home.engine_json, "--ip",
            "127.0.0.1", "--port", "0", "--port-file", pf, "--edge", edge]
    if trigger == "poll":
        argv += ["--foldin-poll", "0.1"]
    deploy = home.in_thread(*argv)
    port = _wait_port(pf)
    watch = None
    try:
        inv = {}
        reloads = _reloads(port)
        inv["cold_start_is_fallback"] = _post(
            port, "/queries.json", {"user": "fresh", "num": 3}) == {
            "itemScores": []}
        # the daemon starts at the high-water mark: nothing re-folded
        watch = home.in_thread(
            "foldin", "--engine-json", home.engine_json, "--watch",
            "--from-now", "--interval", "0.05", "--max-cycles", "3")
        time.sleep(0.5)
        base = home.storage.model_data_dir() / home.iid
        key = model_key(home.iid, 0, "als")
        assert not list(base.glob("*-delta-*.npz"))
        home.rate([("fresh", f"i{i}", 5.0) for i in (1, 3, 5, 7)])
        _wait((base / delta_file_name(key, 1)).exists, "the first link")
        chain, _ = load_model_delta_chain(base, key)
        inv["foldin_produces_delta"] = (
            list(chain[0].new_user_ids) == ["fresh"]
            and chain[0].meta["baseUsers"] == N_USERS)
        if trigger == "apply":
            out = _post(port, "/foldin/apply", {})
            assert out["applied"] == 1 and out["foldinDeltasApplied"] == 1
        fresh = _wait(lambda: _post(port, "/queries.json", {
            "user": "fresh", "num": 3})["itemScores"], "a fresh reply")
        _same_reply({"itemScores": fresh}, home.predict_on_chain("fresh"))
        status = _get(port, "/")
        inv["serving_applies_without_reload"] = (
            len(fresh) == 3 and _reloads(port) == reloads
            and status["engineInstanceId"] == home.iid)
        metrics = _get(port, "/metrics")
        inv["status_reports_freshness"] = (
            "modelFreshnessSec" in status
            and status["foldinWatermarkLag"] == 0
            and status["foldinDeltasApplied"] == 1
            and all(f in metrics for f in (
                "pio_model_freshness_seconds", "pio_foldin_watermark_lag",
                "pio_foldin_applies_total")))
        sizes = []
        for k, uid in enumerate(("fresh2", "fresh3")):
            home.rate([(uid, f"i{i}", 4.0) for i in (0, 2, 4)])
            _wait((base / delta_file_name(key, k + 2)).exists,
                  f"link {k + 2}")
            sizes.append(FoldInSolver.cache_size())
        watch.join(timeout=30)
        inv["solver_signature_stable"] = (
            not watch.is_alive() and sizes[0] == sizes[1] >= 1)
        assert inv == dict.fromkeys(inv, True), inv
        if trigger == "apply":
            assert _post(port, "/foldin/apply", {})["applied"] == 2
        _wait(lambda: _get(port, "/")["foldinDeltasApplied"] == 3,
              "the last links")
        _same_reply(_post(port, "/queries.json", {"user": "fresh3",
                                                  "num": 3}),
                    home.predict_on_chain("fresh3"))
    finally:
        home.run("undeploy", "--port", str(port))
        deploy.join(timeout=30)
        if watch is not None:
            watch.join(timeout=30)
    assert not deploy.is_alive()


def test_the_router_pushes_links_to_every_replica(tmp_path, monkeypatch):
    """``deploy --replicas 2 --push-foldin`` (two CPU console processes
    behind the router in this process): a link the library's
    ``FoldInRunner`` publishes reaches both replicas through the timed
    push, and ``POST /admin/push-foldin`` walks them in order."""
    home = Home(tmp_path, sharded=True)
    monkeypatch.setenv("PIO_TPU_HOME", home.env["PIO_TPU_HOME"])
    for k, v in home.env.items():
        monkeypatch.setenv(k, v)
    pf = str(tmp_path / "router-port")
    deploy = home.in_thread(
        "deploy", "--engine-json", home.engine_json, "--ip", "127.0.0.1",
        "--port", "0", "--port-file", pf, "--replicas", "2",
        "--health-interval", "0.2", "--push-foldin", "0.2")
    port = None
    try:
        port = _wait_port(pf, timeout=180.0)
        assert _post(port, "/queries.json", {"user": "fresh", "num": 3}) == {
            "itemScores": []}
        runner = FoldInRunner(
            home.storage, home.engine, home.ep, home.iid,
            ctx=WorkflowContext(device="cpu", storage=home.storage,
                                mode="Serving"), from_now=True)
        home.rate([("fresh", f"i{i}", 5.0) for i in (2, 4, 6)])
        assert runner.cycle()["appendedUsers"] == 1
        want = home.predict_on_chain("fresh")
        replicas = _get(port, "/debug/fleet")["replicas"]
        for r in replicas:
            rport = int(r["url"].rsplit(":", 1)[1])
            _wait(lambda p=rport: _get(p, "/").get(
                "foldinDeltasApplied") == 1, f"{r['name']}'s apply")
            _same_reply(_post(rport, "/queries.json",
                              {"user": "fresh", "num": 3}), want)
        pushed = _post(port, "/admin/push-foldin", {})["pushed"]
        assert [(p["replica"], p["status"], p["applied"],
                 p["foldinDeltasApplied"]) for p in pushed] == [
            ("replica-0", 200, 0, 1), ("replica-1", 200, 0, 1)]
    finally:
        if port is not None:
            home.run("undeploy", "--port", str(port))
        deploy.join(timeout=60)
    assert not deploy.is_alive()


VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 2, "lambda": 0.05, "seed": 1}}],
}
# the status fields of the fold-in, compared by value (the freshness
# seconds only by presence)
FOLDIN_FIELDS = ("foldinWatermarkLag", "foldinDeltasApplied",
                 "foldinBreakerState", "lastFoldinError")


class Pair:
    """Per package (``"jax"``, ``"port"``): a home holding the same
    seeded ratings and one instance the JAX package trained (the port's
    model carried by ``model_from_jax``), an engine server on ``edge``,
    a router in front of it and a ``FoldInRunner`` from now."""

    def __init__(self, tmp_path, edge: str):
        self.storage = {
            "jax": JaxStorage({"PIO_TPU_HOME": str(tmp_path / "jax")}),
            "port": Storage({"PIO_TPU_HOME": str(tmp_path / "port")}),
        }
        self.servers, self.routers = {}, {}
        rng = np.random.default_rng(3)
        u, i = np.nonzero(rng.random((N_USERS, N_ITEMS)) < 0.5)
        for name, st in self.storage.items():
            app = st.get_metadata().app_insert("shop")
            st.get_event_store().init_channel(app.id)
        self.rate([(f"u{a}", f"i{b}", float(rng.integers(1, 11) * 0.5))
                   for a, b in zip(u.tolist(), i.tolist())])
        jst = self.storage["jax"]
        jengine = jax_recommendation_engine()
        self.iid = jax_run_train(jengine, jengine.params_from_variant(VARIANT),
                                 ctx=JaxWorkflowContext(storage=jst))
        rec = jst.get_metadata().engine_instance_get(self.iid)
        (jmodel,) = jax_prepare_deploy(
            jengine, jengine.params_from_instance(rec), self.iid,
            JaxWorkflowContext(storage=jst, mode="Serving"))
        pst = self.storage["port"]
        pst.get_metadata().engine_instance_insert(
            EngineInstance(**dataclasses.asdict(rec)))
        engine = recommendation_engine()
        (algo,) = engine._algorithms(engine.params_from_instance(rec))
        save_models(WorkflowContext(device="cpu", storage=pst), self.iid,
                    [("als", algo, model_from_jax(jmodel, "cpu"))])
        engines = {"jax": jengine, "port": engine}
        ctxs = {
            "jax": JaxWorkflowContext(storage=jst, mode="Serving"),
            "port": WorkflowContext(device="cpu", storage=pst,
                                    mode="Serving"),
        }
        servers = {"jax": (JaxEngineServer, JaxServerConfig),
                   "port": (EngineServer, ServerConfig)}
        routers = {"jax": jax_router, "port": port_router}
        runners = {"jax": JaxFoldInRunner, "port": FoldInRunner}
        self.runners = {}
        for name, st in self.storage.items():
            ep = engines[name].params_from_instance(rec)
            server, config = servers[name]
            srv = server(engines[name], ep, self.iid, ctx=ctxs[name],
                         config=config(port=0, edge=edge))
            srv.start_background()
            self.servers[name] = srv
            mod = routers[name]
            router = mod.RouterServer(
                [mod.Replica("replica-0", "127.0.0.1", srv.port)],
                mod.RouterConfig(host="127.0.0.1", port=0,
                                 health_interval_s=0.1))
            router.start_background()
            self.routers[name] = router
            self.runners[name] = runners[name](
                st, engines[name], ep, self.iid, ctx=ctxs[name],
                from_now=True)

    def rate(self, triples) -> None:
        """The same rate events, in the same order, into both homes."""
        for name, event in (("jax", JaxEvent), ("port", Event)):
            self.storage[name].get_event_store().insert_batch([
                event(event="rate", entity_type="user", entity_id=u,
                      target_entity_type="item", target_entity_id=i,
                      properties={"rating": r}) for u, i, r in triples], 1)

    def each(self, fn) -> dict:
        return {name: fn(name) for name in self.storage}

    def close(self) -> None:
        for r in self.routers.values():
            r.stop()
        for s in self.servers.values():
            s.stop()
        for st in self.storage.values():
            st.close()


def _cycle_counts(stats: dict) -> dict:
    """A cycle's stats without the delta file's path (each home's) and
    its seconds."""
    return {k: v for k, v in stats.items()
            if k not in ("delta", "cycleSec")}


def _foldin_fields(out: dict) -> dict:
    assert out["modelFreshnessSec"] >= 0
    return {k: out.get(k) for k in FOLDIN_FIELDS}


def _close_replies(got: dict, want: dict) -> None:
    assert [s["item"] for s in got["itemScores"]] == [
        s["item"] for s in want["itemScores"]]
    g = np.array([s["score"] for s in got["itemScores"]], np.float64)
    w = np.array([s["score"] for s in want["itemScores"]], np.float64)
    scale = max(1.0, float(np.abs(w).max(initial=0.0)))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("edge", ["eventloop", "threads"])
def test_foldin_apply_push_and_status_equal_the_references(tmp_path, edge):
    pair = Pair(tmp_path, edge)
    try:
        routers = pair.each(lambda n: pair.routers[n].port)
        servers = pair.each(lambda n: pair.servers[n].port)
        ask = ("fresh", "u0", "u1")

        def replies(name):
            return [_post(routers[name], "/queries.json",
                          {"user": u, "num": 4}) for u in ask]

        before = pair.each(replies)
        assert before["port"][0] == before["jax"][0] == {"itemScores": []}
        assert "modelFreshnessSec" not in _get(servers["port"], "/")
        # a cold-start user, new ratings of known users, a new item
        pair.rate([("fresh", f"i{k}", 4.5) for k in (1, 3, 5, 7)]
                  + [("u0", "i2", 1.0), ("u0", "inew", 5.0),
                     ("u1", "inew", 4.0)])
        stats = pair.each(lambda n: pair.runners[n].cycle())
        assert _cycle_counts(stats["port"]) == _cycle_counts(stats["jax"])
        assert stats["port"]["appendedUsers"] == 1
        assert stats["port"]["appendedItems"] == 1
        pushed = pair.each(lambda n: _post(routers[n], "/admin/push-foldin",
                                           {})["pushed"])
        for p in pushed["port"] + pushed["jax"]:
            assert p.pop("modelFreshnessSec") >= 0
        assert pushed["port"] == pushed["jax"] == [{
            "replica": "replica-0", "status": 200, "applied": 1,
            "foldinDeltasApplied": 1}]
        after = pair.each(replies)
        assert after["port"][0]["itemScores"]
        for got, want in zip(after["port"], after["jax"]):
            _close_replies(got, want)
        status = pair.each(lambda n: _get(servers[n], "/"))
        assert _foldin_fields(status["port"]) == _foldin_fields(
            status["jax"])
        assert status["port"]["foldinWatermarkLag"] == 0
        # the library's watch loop, then the engine server's own apply
        pair.rate([("fresh2", f"i{k}", 3.0) for k in (0, 2, 4)])
        assert pair.each(lambda n: pair.runners[n].watch(
            interval_s=0.05, max_cycles=1)) == {"jax": 1, "port": 1}
        applied = pair.each(lambda n: _post(servers[n], "/foldin/apply",
                                            {}))
        assert applied["port"]["applied"] == applied["jax"]["applied"] == 1
        assert _foldin_fields(applied["port"]) == _foldin_fields(
            applied["jax"])
        assert sorted(applied["port"]) == sorted(applied["jax"])
        fresh2 = pair.each(lambda n: _post(routers[n], "/queries.json",
                                           {"user": "fresh2", "num": 4}))
        assert fresh2["port"]["itemScores"]
        _close_replies(fresh2["port"], fresh2["jax"])
    finally:
        pair.close()
