"""The port's engine registry conformance suite.

One parametrized test drives every engine the port registers through the
whole platform, on the CPU: train -> deploy (a real HTTP server) ->
query -> feedback -> eval dispatch, plus one chaos scenario (the
``storage.write`` fault point on the ingest path answers a structured
503, then the same request succeeds) and one metrics check (the
engine-labeled ``pio_engine_queries_total`` counter moved), as the
reference's ``tests/test_engine_conformance.py`` does for its engines.
An engine whose spec declares a ``ConformanceFixture`` is on the
parametrize list by registration alone.

Each port fixture must also be the reference fixture: the same app, the
same events field by field (all but the times minted at creation), the
same queries and the same tiny-train variant.  The fixture data is tiny:
the suite holds the wiring; the per-engine parity tests hold the math.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from predictionio_tpu.engines import list_engine_specs as jax_specs
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.engines import list_engine_specs
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.storage import Storage, reset_storage
from predictionio_tpu_torch.storage.metadata import AccessKey
from predictionio_tpu_torch.workflow import run_train

SPECS = {s.name: s for s in list_engine_specs()}
REF = {s.name: s for s in jax_specs()}
ENGINES = ["classification", "ecommercerecommendation", "itemsimilarity",
           "nextitem", "recommendation", "similarproduct", "trending"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _post(url: str, payload, timeout: float = 30.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def _get(url: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _engine_ok_count(metrics_text: str, engine: str) -> float:
    """``pio_engine_queries_total{engine=...,status="ok"}`` of an
    exposition, whatever the label order."""
    for line in metrics_text.splitlines():
        if (line.startswith("pio_engine_queries_total{")
                and f'engine="{engine}"' in line
                and 'status="ok"' in line):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_every_builtin_engine_declares_conformance_as_the_reference():
    """The port registers the reference's seven engines (five
    model-backed, trending and nextitem), each with a fixture, under the
    reference's names."""
    assert sorted(SPECS) == ENGINES
    assert set(SPECS) <= set(REF)
    missing = [s.name for s in SPECS.values()
               if s.source == "builtin" and s.conformance is None]
    assert not missing
    for name, spec in SPECS.items():
        assert spec.describe()["conformance"] is True
        assert REF[name].describe()["conformance"] is True


REPLIES = (
    {"itemScores": []},
    {"itemScores": [{"item": "i1", "score": 0.5}]},
    {"itemScores": [{"item": "i0", "score": 0.5}]},
    {"label": "hot"},
    {"label": "warm"},
)


def _fields(ev) -> dict:
    d = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)
         if f.name not in ("event_time", "creation_time")}
    d["properties"] = dict(d["properties"].fields)
    return d


@pytest.mark.parametrize("name", ENGINES)
def test_fixture_is_the_references(name):
    port, ref = SPECS[name].conformance, REF[name].conformance
    assert port.app_name == ref.app_name
    assert port.queries == ref.queries
    assert port.variant == ref.variant
    got = [_fields(e) for e in port.seed_events()]
    want = [_fields(e) for e in ref.seed_events()]
    assert got == want and got
    # the port's check judges a reply as the reference's does
    for reply in REPLIES:
        assert port.check(reply) == ref.check(reply), reply


@pytest.mark.parametrize("name", ENGINES)
def test_engine_conformance(name, tmp_path):
    from predictionio_tpu_torch.server.event_server import (
        EventServer, EventServerConfig,
    )
    from predictionio_tpu_torch.server.serving import (
        EngineServer, ServerConfig,
    )

    spec = SPECS[name]
    fix = spec.conformance
    storage = Storage({"PIO_TPU_HOME": str(tmp_path)})
    reset_storage(storage)
    ev_srv = srv = None
    try:
        md = storage.get_metadata()
        app = md.app_insert(fix.app_name)
        access_key = md.access_key_insert(AccessKey(key="", appid=app.id))
        es = storage.get_event_store()
        es.init_channel(app.id)

        # chaos: a faulting store answers a structured 503 with
        # Retry-After after its bounded retries, and the same request
        # succeeds once the fault clears
        ev_srv = EventServer(storage, EventServerConfig(
            port=0, write_retries=2, write_backoff_s=0.01,
        ))
        ev_srv.start_background()
        es_url = f"http://127.0.0.1:{ev_srv.config.port}"
        probe = {"event": "conf_probe", "entityType": "user",
                 "entityId": "probe"}
        faults.arm("storage.write:exc=operational")
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{es_url}/events.json?accessKey={access_key}", probe)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After")
        finally:
            faults.disarm()
        status, _ = _post(f"{es_url}/events.json?accessKey={access_key}",
                          probe)
        assert status == 201

        # seed and train
        es.insert_batch(list(fix.seed_events()), app_id=app.id)
        engine = spec.build()
        ep = engine.params_from_variant(dict(fix.variant))
        ctx = WorkflowContext(device="cpu", storage=storage)
        iid = run_train(engine, ep, ctx=ctx, engine_id=spec.name,
                        engine_variant=spec.instance_variant_key())

        # deploy: real HTTP, the feedback loop wired to the event server
        srv = EngineServer(
            engine, ep, iid,
            ctx=WorkflowContext(device="cpu", storage=storage,
                                mode="Serving"),
            config=ServerConfig(
                port=0, microbatch="off", feedback=True,
                event_server_url=es_url, access_key=access_key,
            ),
            engine_id=spec.name,
            engine_variant=spec.instance_variant_key(),
        )
        srv.start_background()
        base = f"http://127.0.0.1:{srv.port}"

        # query; the engine-labeled counter must move
        before = _engine_ok_count(_get(f"{base}/metrics"), spec.name)
        for q in fix.queries:
            status, result = _post(f"{base}/queries.json", q)
            assert status == 200
            assert fix.check(result), f"{name}: check failed on {result}"
        after = _engine_ok_count(_get(f"{base}/metrics"), spec.name)
        assert after - before >= len(fix.queries), (before, after)

        # feedback: the predict event lands back in the store
        deadline = time.monotonic() + 10.0
        fed = []
        while time.monotonic() < deadline and not fed:
            fed = list(es.find(app_id=app.id, entity_type="pio_pr"))
            if not fed:
                time.sleep(0.05)
        assert fed, f"{name}: the feedback predict event never arrived"
        assert fed[0].event == "predict"

        # eval dispatch: engines with a real read_eval give scored sets,
        # the rest an empty list
        results = engine.eval(ctx, ep)
        assert isinstance(results, list)
        assert bool(results) == (name == "recommendation")
        for _ei, qpa in results:
            assert isinstance(qpa, list) and qpa
    finally:
        if srv is not None:
            srv.stop()
        if ev_srv is not None:
            ev_srv.stop()
        reset_storage(None)


def test_engine_counter_parse_takes_either_label_order():
    text = 'pio_engine_queries_total{engine="x",status="ok"} 3\n'
    assert _engine_ok_count(text, "x") == 3.0
    text2 = 'pio_engine_queries_total{status="ok",engine="x"} 2\n'
    assert _engine_ok_count(text2, "x") == 2.0


def test_scaffolded_engine_dirs_load_in_turn_in_one_process(tmp_path):
    """``template get`` of two engines, then their engine.json files
    loaded in turn, back and forth, in one process: each load gives its
    own dir's engine (the scaffold's ``engine.py`` is the module
    ``engine`` of every dir)."""
    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.engines import spec_name_of
    from predictionio_tpu_torch.tools.template_gallery import scaffold

    dirs = {name: scaffold(name, tmp_path / name)
            for name in ("similarproduct", "classification")}
    for name in ("similarproduct", "classification", "similarproduct",
                 "classification"):
        engine, ep, variant = load_engine_from_variant(
            dirs[name] / "engine.json")
        assert spec_name_of(engine) == name
        assert variant["id"] == name
