"""The port's tenant registry against the JAX package's, on the CPU.

One seeded script of registry operations (resolve by app, access key,
explicit and assigned variant; leases held in flight and completed ok or
with errors; explicit evictions, pins, budget changes, live adds and
removes) runs through both packages' ``TenantRegistry`` with stub
loaders of fixed sizes: every step's outcome, the resident keys, the
loads and evictions in their order, the overcommits and ``summary()``
are equal.  Then fold-in: the JAX package trains an instance, the port
gets the same instance and model (``convert.model_from_jax``), each
package's ``FoldInRunner`` publishes a delta link from the same events,
and each registry's ``apply_available_deltas`` patches its resident
tenant from its own chain: the factors agree within 1e-5, the anchor is
left to its server, and a second walk applies nothing.  The port's
engine server also applies the chain when it loads a tenant lazily.
"""

import dataclasses

import numpy as np
import pytest

from predictionio_tpu import tenancy as jax_tenancy
from predictionio_tpu.controller.base import (
    WorkflowContext as JaxWorkflowContext,
)
from predictionio_tpu.live import FoldInRunner as JaxFoldInRunner
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine,
)
from predictionio_tpu.tenancy.registry import (
    TenantRuntime as JaxTenantRuntime,
)
from predictionio_tpu.workflow.train import (
    prepare_deploy as jax_prepare_deploy,
    prepare_deploy_components as jax_prepare_deploy_components,
    run_train as jax_run_train,
)
from predictionio_tpu_torch import tenancy
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.live import FoldInRunner
from predictionio_tpu_torch.server import EngineServer, ServerConfig
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.metadata import EngineInstance
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.tenancy.registry import TenantRuntime
from predictionio_tpu_torch.workflow import prepare_deploy_components
from predictionio_tpu_torch.workflow.model_io import save_models

PACKAGES = {"jax": (jax_tenancy, JaxTenantRuntime),
            "port": (tenancy, TenantRuntime)}
N_APPS = 6


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)


class Hive:
    """One package's registry over stub runtimes of fixed sizes, with
    the loads and the closed (unloaded) runtimes logged in order."""

    def __init__(self, name: str, sizes: dict):
        mod, runtime = PACKAGES[name]
        self.mod = mod
        self.log = []
        specs = [mod.TenantSpec(f"app{i}", v, engine_json="x.json",
                                weight=1.0 + i % 3, pinned=(i == 4),
                                access_key=f"K{i}" if i % 2 else None,
                                quota_qps=0.01 if i == 5 else None,
                                quota_burst=2.0 if i == 5 else None)
                 for i in range(N_APPS) for v in ("main", "alt")[:1 + i % 2]]

        def load(spec):
            if spec.app == "app3" and spec.variant == "alt":
                raise RuntimeError("boom")
            self.log.append(("load", spec.key))
            rt = runtime(spec, engine=None, engine_params=None,
                         instance_id=f"iid-{spec.key_str}", algorithms=[],
                         models=[], serving=None, batcher=None,
                         query_decoder=lambda d: d, ctx=None,
                         quota=(mod.TokenBucket(spec.quota_qps,
                                                spec.quota_burst)
                                if spec.quota_qps else None))
            rt.resident_bytes = sizes[spec.key_str]
            return rt

        self.reg = mod.TenantRegistry(specs, memory_budget_bytes=400,
                                      salt="t", loader=load)
        close = self.reg._close_runtime

        def closed(rt):
            self.log.append(("close", rt.key))
            close(rt)

        self.reg._close_runtime = closed
        self.held = []

    def step(self, op: tuple):
        kind, arg = op
        reg = self.reg
        if kind == "resolve":
            query, status = arg
            out = _outcome(lambda: reg.resolve(query))
            if out[0] != "ok":
                return out
            lease = out[1]
            if status == "hold":
                self.held.append(lease)
            else:
                lease.complete(status)
            return "ok", (lease.key_str, lease.variant, lease.assigned)
        if kind == "release":
            if self.held:
                self.held.pop(0).complete("ok")
            return "ok", len(self.held)
        if kind == "evict":
            return _outcome(lambda: reg.evict(arg))
        if kind == "budget":
            return _outcome(lambda: reg.set_memory_budget(arg))
        if kind == "add":
            return _outcome(lambda: reg.add_tenant(self.mod.TenantSpec(
                arg[0], arg[1], engine_json="x.json", weight=2.0)))
        if kind == "remove":
            return _outcome(lambda: reg.remove_tenant(arg,
                                                      drain_timeout_s=0.05))
        if kind == "weights":
            return _outcome(lambda: reg.set_weights(*arg))
        raise AssertionError(kind)

    def view(self) -> dict:
        summary = self.reg.summary()
        dbg = self.reg.debug_payload()
        dbg.pop("deviceMemory", None)
        for rt in dbg["resident_tenants"].values():
            rt.pop("modelFreshnessSec")
        return {"resident": sorted(self.reg.resident_keys()),
                "summary": summary, "log": list(self.log),
                "debug": dbg}


def _script(rng, n: int = 160) -> list:
    apps = [f"app{i}" for i in range(N_APPS)] + ["ghost"]
    ops = []
    for _ in range(n):
        r = rng.random()
        app = str(rng.choice(apps))
        if r < 0.55:
            query = {"app": app, "user": f"u{rng.integers(50)}"}
            if rng.random() < 0.3:
                query["variant"] = str(rng.choice(["main", "alt", "nope"]))
            if rng.random() < 0.1:
                query = {"accessKey": str(rng.choice(["K1", "K3", "bad"])),
                         "user": "u1"}
            if rng.random() < 0.05:
                query = {"user": "u2"}
            status = str(rng.choice(["ok", "ok", "ok", "error", "hold",
                                     "bad_request"]))
            ops.append(("resolve", (query, status)))
        elif r < 0.65:
            ops.append(("release", None))
        elif r < 0.72:
            ops.append(("evict", (app, str(rng.choice(["main", "alt"])))))
        elif r < 0.80:
            ops.append(("budget", int(rng.choice([0, 150, 250, 400, 700]))))
        elif r < 0.86:
            ops.append(("add", (app, f"v{rng.integers(3)}")))
        elif r < 0.93:
            ops.append(("remove", (app, str(rng.choice(["main", "alt",
                                                         "v1"])))))
        else:
            ops.append(("weights", (app, {"main": float(rng.uniform(0, 2)),
                                          "alt": 1.0})))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_the_same_script_gives_the_same_registry(seed):
    rng = np.random.default_rng(seed)
    sizes = {f"app{i}/{v}": int(rng.integers(50, 200))
             for i in range(N_APPS) for v in ("main", "alt", "v0", "v1",
                                              "v2")}
    hives = {n: Hive(n, sizes) for n in PACKAGES}
    try:
        for k, op in enumerate(_script(rng)):
            got = {n: h.step(op) for n, h in hives.items()}
            assert got["port"] == got["jax"], (k, op)
            views = {n: h.view() for n, h in hives.items()}
            assert views["port"] == views["jax"], (k, op)
        final = views["port"]
        # the script exercised the budget, the pins and the failures
        assert final["summary"]["evictions"] > 0
        assert final["summary"]["overcommits"] > 0
        assert any(e[0] == "close" for e in final["log"])
    finally:
        for h in hives.values():
            h.reg.close()


N_USERS, N_ITEMS = 14, 10
VARIANT = {
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 6, "numIterations": 2, "lambda": 0.05, "seed": 1}}],
}


def test_apply_available_deltas_patches_each_tenant_alike(tmp_path):
    homes = {
        "jax": JaxStorage({"PIO_TPU_HOME": str(tmp_path / "jax")}),
        "port": Storage({"PIO_TPU_HOME": str(tmp_path / "port")}),
    }
    events = {"jax": JaxEvent, "port": Event}
    rng = np.random.default_rng(5)
    triples = [(f"u{u}", f"i{i}", float(rng.integers(1, 11) * 0.5))
               for u in range(N_USERS)
               for i in rng.choice(N_ITEMS, 5, replace=False)]

    def rate(rows):
        for n, st in homes.items():
            st.get_event_store().insert_batch([events[n](
                event="rate", entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties={"rating": r}) for u, i, r in rows], 1)

    for st in homes.values():
        app = st.get_metadata().app_insert("shop")
        st.get_event_store().init_channel(app.id)
    rate(triples)
    jst, pst = homes["jax"], homes["port"]
    jengine = jax_recommendation_engine()
    iid = jax_run_train(jengine, jengine.params_from_variant(VARIANT),
                        ctx=JaxWorkflowContext(storage=jst))
    rec = jst.get_metadata().engine_instance_get(iid)
    (jmodel,) = jax_prepare_deploy(
        jengine, jengine.params_from_instance(rec), iid,
        JaxWorkflowContext(storage=jst, mode="Serving"))
    pst.get_metadata().engine_instance_insert(
        EngineInstance(**dataclasses.asdict(rec)))
    engine = recommendation_engine()
    (algo,) = engine._algorithms(engine.params_from_instance(rec))
    pctx = WorkflowContext(device="cpu", storage=pst, mode="Serving")
    save_models(pctx, iid, [("als", algo, model_from_jax(jmodel, "cpu"))])
    engines = {"jax": jengine, "port": engine}
    ctxs = {"jax": JaxWorkflowContext(storage=jst, mode="Serving"),
            "port": pctx}
    prepare = {"jax": jax_prepare_deploy_components,
               "port": prepare_deploy_components}
    runners = {"jax": JaxFoldInRunner, "port": FoldInRunner}
    regs, models = {}, {}
    try:
        for n, (mod, runtime) in PACKAGES.items():
            ep = engines[n].params_from_instance(rec)
            runner = runners[n](homes[n], engines[n], ep, iid,
                                ctx=ctxs[n], from_now=True)
            specs = [mod.TenantSpec("shop", v, engine=engines[n],
                                    engine_params=ep, instance_id=iid,
                                    ctx=ctxs[n])
                     for v in ("anchor", "tenant")]

            def load(spec, n=n, runtime=runtime):
                algos, ms, serving = prepare[n](spec.engine,
                                                spec.engine_params,
                                                spec.instance_id,
                                                ctx=spec.ctx)
                models[n, spec.variant] = ms[0]
                return runtime(spec, spec.engine, spec.engine_params,
                               spec.instance_id, algos, ms, serving, None,
                               lambda d: d, spec.ctx)

            reg = mod.TenantRegistry(specs, salt="t", loader=load)
            regs[n] = reg
            reg.adopt_anchor(load(specs[0]))
            reg.get_runtime(("shop", "tenant"))
            regs[n, "runner"] = runner
        # a cold-start user, new ratings of known users, a new item
        rate([("fresh", "i1", 4.5), ("fresh", "i3", 2.0), ("u0", "i2", 1.0),
              ("u0", "inew", 5.0), ("u1", "inew", 4.0)])
        for n in PACKAGES:
            assert regs[n, "runner"].cycle()["appendedUsers"] == 1
        applied = {n: regs[n].apply_available_deltas() for n in PACKAGES}
        assert applied == {"jax": 1, "port": 1}
        assert {n: regs[n].apply_available_deltas() for n in PACKAGES} == {
            "jax": 0, "port": 0}
        jm, pm = models["jax", "tenant"], models["port", "tenant"]
        assert list(pm.users.ids) == list(jm.users.ids)
        assert list(pm.items.ids) == list(jm.items.ids)
        assert "fresh" in list(pm.users.ids)
        for f in ("user_factors", "item_factors"):
            np.testing.assert_allclose(
                np.asarray(getattr(pm, f)), np.asarray(getattr(jm, f)),
                rtol=0, atol=1e-5)
        # the anchor rides its server's own walk
        assert "fresh" not in list(models["port", "anchor"].users.ids)
        snaps = {n: regs[n].debug_payload()["resident_tenants"][
            "shop/tenant"] for n in PACKAGES}
        for s in snaps.values():
            s.pop("modelFreshnessSec")
            s.pop("residentBytes")
        assert snaps["port"] == snaps["jax"]
        assert snaps["port"]["foldinDeltasApplied"] == 1
        # the port's engine server applies the chain at a lazy load too
        # (the reference's loader leaves it to the next poll or push)
        ep = engine.params_from_instance(rec)
        spec = [tenancy.TenantSpec("shop", v, engine=engine,
                                   engine_params=ep, instance_id=iid,
                                   ctx=pctx) for v in ("anchor", "tenant")]
        regs["lazy"] = tenancy.TenantRegistry(spec, salt="t")
        srv = EngineServer(engine, ep, iid, ctx=pctx, config=ServerConfig(
            port=0, microbatch="off"), tenants=regs["lazy"])
        try:
            rt = regs["lazy"].get_runtime(("shop", "tenant"))
            assert rt.foldin_deltas_applied == 1
            assert "fresh" in list(rt.models[0].users.ids)
            np.testing.assert_allclose(rt.models[0].user_factors,
                                       pm.user_factors, rtol=0, atol=0)
            # the anchor is the server's: its own load caught it up
            assert srv.foldin_deltas_applied == 1
        finally:
            srv.stop()
    finally:
        for n in PACKAGES:
            if n in regs:
                regs[n].close()
        for st in homes.values():
            st.close()
