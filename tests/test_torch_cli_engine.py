"""The port's console against the JAX package's on the engine commands:
``template list|get`` (and ``--from-archive``), ``engines``, ``build``,
``unregister`` and the template min-version gate, ``run``, ``train``
to a COMPLETED instance, ``deploy`` on the default event-loop edge
answering like an in-process ``predict``, then ``undeploy``, and
``deploy --replicas 2`` answering through its router.

Each console runs on its own scratch home with the same argv; stdout and
exit codes are compared with access keys, instance ids, homes and the
package name masked.  ``train`` is not compared number for number (the
JAX trainer draws its initial factors from ``jax.random``); factor
parity is held in ``tests/test_torch_recommendation.py``.
"""

import json
import os
import shutil
import tarfile
import threading
import time
import zipfile

import numpy as np
import pytest

from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.storage import Event
from predictionio_tpu_torch.templates.recommendation import (
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import prepare_deploy_components
# the two consoles on two homes, and their fixture
from test_torch_cli import Pair, pair  # noqa: F401

FACTORY = "{pkg}.templates.recommendation.recommendation_engine"
# the engines the port registers, by name
PORT_ENGINES = ["classification", "ecommercerecommendation",
                "itemsimilarity", "nextitem", "recommendation",
                "similarproduct", "trending"]


def _rated_app(pair, name="cliapp"):
    """The same seeded rate events and item categories in both homes."""
    pair.run("app", "new", name)
    rng = np.random.default_rng(0)
    rows = [(u, int(i), float(rng.integers(1, 6)))
            for u in range(8) for i in rng.choice(10, size=5, replace=False)]
    for kind, cls in (("jax", JaxEvent), ("torch", Event)):
        es = pair.storage[kind].get_event_store()
        es.insert_batch([
            cls(event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties={"rating": r}) for u, i, r in rows
        ] + [
            cls(event="$set", entity_type="item", entity_id=f"i{j}",
                properties={"categories": ["even" if j % 2 == 0 else "odd"]})
            for j in range(10)
        ], 1)


def _engine_json(pair, tmp_path, **extra):
    """An engine.json per console naming its own package's factory."""
    for kind in ("jax", "torch"):
        d = tmp_path / f"engine-{kind}"
        d.mkdir(exist_ok=True)
        (d / "engine.json").write_text(json.dumps({
            "id": "cli-test",
            "engineFactory": FACTORY.format(pkg=Pair.PKG[kind]),
            "datasource": {"params": {"appName": "cliapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 2, "lambda": 0.1, "seed": 1}}],
            **extra,
        }))
    return str(tmp_path / "engine-{kind}" / "engine.json")


def test_template_list_and_get_equal(pair, tmp_path):
    lines = {k: pair.one(k, "template", "list")[1].splitlines()
             for k in ("jax", "torch")}
    # the port's gallery holds the engines it registers, each a line of
    # the reference's gallery
    names = [ln.split()[0] for ln in lines["torch"]]
    assert names == PORT_ENGINES
    assert set(names) <= {ln.split()[0] for ln in lines["jax"]}
    assert lines["torch"][names.index("recommendation")].startswith(
        f"{'recommendation':<26} ")
    assert pair.run("template", "get", "recommendation",
                    "{home}/my-engine") == (
        0, "Engine template 'recommendation' created at <HOME>/my-engine/\n")
    scaffolds = {}
    for kind, home in pair.homes.items():
        target = home / "my-engine"
        assert sorted(p.name for p in target.iterdir()) == [
            "README.md", "engine.json", "engine.py", "template.json"]
        variant = json.loads((target / "engine.json").read_text())
        variant.pop("description")
        scaffolds[kind] = (variant,
                           json.loads((target / "template.json").read_text()))
    assert scaffolds["torch"] == scaffolds["jax"]
    assert "predictionio_tpu_torch.templates.recommendation" in (
        pair.homes["torch"] / "my-engine" / "engine.py").read_text()
    rc, out = pair.run("template", "get", "recommendation", "{home}/my-engine")
    assert rc == 1 and "not empty" in out
    rc, out = pair.one("torch", "template", "get", "nope", "{home}/x")
    assert rc == 1 and out.startswith("Error: \"unknown template 'nope'")


def test_template_get_from_archive_equal(pair, tmp_path):
    src = tmp_path / "src" / "my-engine-main"
    src.mkdir(parents=True)
    (src / "engine.json").write_text(json.dumps({"id": "arch"}))
    (src / "notes.txt").write_text("hello")
    zpath = tmp_path / "engine.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for p in src.iterdir():
            zf.write(p, f"my-engine-main/{p.name}")
    assert pair.run("template", "get", "arch", "{home}/from-zip",
                    "--from-archive", str(zpath)) == (
        0, "Engine template 'arch' created at <HOME>/from-zip/\n")
    for home in pair.homes.values():
        assert (home / "from-zip" / "notes.txt").read_text() == "hello"
        assert (home / "from-zip" / "template.json").exists()
    # link members are refused and leave no partial target behind
    tpath = tmp_path / "bad.tar"
    (tmp_path / "link").symlink_to("/etc/passwd")
    with tarfile.open(tpath, "w") as tf:
        tf.add(src / "engine.json", "engine.json")
        tf.add(tmp_path / "link", "link")
    rc, out = pair.run("template", "get", "bad", "{home}/bad",
                       "--from-archive", str(tpath))
    assert rc == 1 and "link member" in out
    rc, out = pair.run("template", "get", "gone", "{home}/gone",
                       "--from-archive", str(tmp_path / "missing.zip"))
    assert rc == 1 and "archive not found" in out


def test_engines_list_and_describe(pair):
    listed = pair.one("torch", "engines", "list")
    assert listed[0] == 0 and listed[1].splitlines()[-1] == (
        f"({len(PORT_ENGINES)} engines registered)")
    desc = {k: pair.one(k, "engines", "describe", "recommendation")
            for k in ("jax", "torch")}
    assert desc["torch"][0] == desc["jax"][0] == 0
    port, ref = (json.loads(desc[k][1]) for k in ("torch", "jax"))
    assert port.keys() == ref.keys()
    for key in ("name", "source", "defaultParams", "queryExample"):
        assert port[key] == ref[key]
    # after the package mask
    assert port["factory"] == ref["factory"]
    # the evaluation's dotted path (its name masked like a key)
    assert port["evaluation"] == ref["evaluation"] == (
        "predictionio_tpu.templates.recommendation.<KEY>")
    rc, out = pair.one("torch", "engines", "describe", "nope")
    assert rc == 1 and out.startswith(
        "Error: no engine named 'nope' is registered; known: "
        + ", ".join(PORT_ENGINES))


def test_build_unregister_and_the_min_version_gate(pair):
    pair.run("template", "get", "recommendation", "{home}/eng")
    assert pair.run("build", "--engine-json", "{home}/eng/engine.json") == (
        0, "Engine 'recommendation' built and registered (version 1).\n")
    for kind, st in pair.storage.items():
        (m,) = st.get_metadata().manifest_get_all()
        assert (m.id, m.version, m.engine_factory) == (
            "recommendation", "1", "engine.engine_factory")
    assert pair.run("unregister", "--engine-json",
                    "{home}/eng/engine.json") == (
        0, "Engine 'recommendation' unregistered.\n")
    assert pair.storage["torch"].get_metadata().manifest_get_all() == []
    for home in pair.homes.values():
        (home / "eng" / "template.json").write_text(
            json.dumps({"pio": {"version": {"min": "99.0.0"}}}))
    rc, out = pair.run("build", "--engine-json", "{home}/eng/engine.json")
    assert rc == 1 and "template requires predictionio_tpu >= 99.0.0" in out
    assert pair.run("train", "--engine-json", "{home}/eng/engine.json") == (
        rc, out)
    assert pair.run("run", "os.path.join", "a", "b") == (0, "")
    assert pair.run("run", "os.sep") == (
        1, "Error: os.sep resolved to a non-callable str.\n")


def test_train_to_a_completed_instance(pair, tmp_path):
    _rated_app(pair)
    ej = _engine_json(pair, tmp_path)
    assert pair.run("deploy", "--engine-json", ej, "--port", "0") == (
        1, "Error: no completed engine instance found; run train first.\n")
    rc, out = pair.run("train", "--engine-json", ej)
    assert rc == 0 and out == "Training completed. Engine instance id: <ID>\n"
    md = pair.storage["torch"].get_metadata()
    (rec,) = md.engine_instance_get_all()
    assert (rec.status, rec.engine_id, rec.engine_variant) == (
        "COMPLETED", "cli-test", ej.format(kind="torch"))
    assert (pair.homes["torch"] / "models" / rec.id).is_dir()
    # the console's own process takes the card, which this host lacks
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair.one("torch", "train", "--engine-json", ej, device="cuda")


def _wait_port(path, thread, timeout=60.0) -> int:
    deadline = time.monotonic() + timeout
    while not path.exists() or not path.read_text().strip():
        assert thread.is_alive(), "deploy exited before binding"
        assert time.monotonic() < deadline, "deploy did not bind"
        time.sleep(0.05)
    return int(path.read_text())


def test_deploy_on_the_event_loop_edge_then_undeploy(pair, tmp_path):
    _rated_app(pair)
    ej = _engine_json(pair, tmp_path)
    assert pair.one("torch", "train", "--engine-json", ej)[0] == 0
    st = pair.storage["torch"]
    pf = tmp_path / "port"
    rcs = []
    argv = ["deploy", "--engine-json", ej.format(kind="torch"), "--ip",
            "127.0.0.1", "--port", "0", "--port-file", str(pf)]
    thread = threading.Thread(
        target=lambda: rcs.append(main(argv, storage=st, device="cpu")),
        daemon=True)
    thread.start()
    port = _wait_port(pf, thread)
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        json.loads(open(ej.format(kind="torch")).read()))
    (iid,) = [r.id for r in st.get_metadata().engine_instance_get_all()]
    algos, models, _ = prepare_deploy_components(
        engine, ep, iid, ctx=WorkflowContext(device="cpu", storage=st,
                                             mode="Serving"))
    import urllib.request

    queries = [{"user": f"u{u}", "num": 4} for u in range(8)] + [
        {"user": "u1", "num": 3, "categories": ["even"]},
        {"user": "nobody", "num": 4}]
    for q in queries:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        want = algos[0].predict(models[0], Query.from_json(q)).to_json()
        assert [s["item"] for s in got["itemScores"]] == [
            s["item"] for s in want["itemScores"]]
        assert np.allclose([s["score"] for s in got["itemScores"]],
                           [s["score"] for s in want["itemScores"]],
                           rtol=1e-5, atol=1e-6)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                timeout=60) as r:
        status = json.loads(r.read())
    assert status["engineInstanceId"] == iid
    assert status["microbatch"]["shared"] is True
    rc, out = pair.one("torch", "undeploy", "--port", str(port))
    thread.join(timeout=30)
    assert not thread.is_alive() and rcs == [0]
    # the deploy thread's line is captured with the undeploy's
    assert rc == 0 and sorted(out.splitlines()) == [
        f"Deploying engine instance <ID> on 127.0.0.1:{port}",
        f"Undeployed engine server at 127.0.0.1:{port}."]
    shutil.rmtree(tmp_path / "engine-torch")


def test_deploy_replicas_answers_through_its_router(pair, tmp_path,
                                                    monkeypatch):
    """``deploy --replicas 2`` on the host: two replica processes (the
    console on the CPU, on the same home) behind the router in this
    process; the replies equal an in-process ``predict``, both replicas
    serve, ``/debug/fleet`` lists them, and ``undeploy`` stops the
    router and its replicas."""
    import urllib.request

    _rated_app(pair)
    ej = _engine_json(pair, tmp_path).format(kind="torch")
    assert pair.one("torch", "train", "--engine-json", ej)[0] == 0
    st = pair.storage["torch"]
    monkeypatch.setenv("PIO_TPU_HOME", str(pair.homes["torch"]))
    pf = tmp_path / "router-port"
    rcs = []
    argv = ["deploy", "--engine-json", ej, "--ip", "127.0.0.1", "--port",
            "0", "--port-file", str(pf), "--replicas", "2",
            "--health-interval", "0.2"]
    thread = threading.Thread(
        target=lambda: rcs.append(main(argv, storage=st, device="cpu")),
        daemon=True)
    thread.start()
    port = None
    try:
        port = _wait_port(pf, thread, timeout=180.0)
        engine = recommendation_engine()
        ep = engine.params_from_variant(json.loads(open(ej).read()))
        (iid,) = [r.id for r in st.get_metadata().engine_instance_get_all()]
        algos, models, _ = prepare_deploy_components(
            engine, ep, iid, ctx=WorkflowContext(device="cpu", storage=st,
                                                 mode="Serving"))
        for u in range(8):
            q = {"user": f"u{u}", "num": 4}
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=json.dumps(q).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                got = json.loads(r.read())
            want = algos[0].predict(models[0], Query.from_json(q)).to_json()
            assert [s["item"] for s in got["itemScores"]] == [
                s["item"] for s in want["itemScores"]]
            assert np.allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]],
                               rtol=1e-5, atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/fleet",
                                    timeout=60) as r:
            fleet = json.loads(r.read())
        assert [r["name"] for r in fleet["replicas"]] == [
            "replica-0", "replica-1"]
        assert all(r["forwarded"] == 4 for r in fleet["replicas"])
        assert fleet["healthyReplicas"] == 2
    finally:
        if port is not None:
            rc, out = pair.one("torch", "undeploy", "--port", str(port))
        thread.join(timeout=60)
    assert not thread.is_alive() and rcs == [0]
    assert rc == 0
    lines = out.splitlines()
    assert f"Router fronting 2 replicas on 127.0.0.1:{port}" in lines
    pids = [int(ln.split("(pid ")[1].split(")")[0]) for ln in lines
            if ln.startswith("Replica ")]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
