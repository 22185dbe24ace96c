"""The port's console against the JAX package's: the app, channel and
access-key commands, data-delete and trim, import/export, status,
version, help and upgrade, the event server, and every refusal.

Each case runs the port's ``main(argv, storage, device="cpu")`` and the
JAX ``main(argv, storage)`` with the same argv on two scratch homes and
compares stdout and exit codes, with access keys, homes and the package
name masked.
"""

import datetime as dt
import http.client
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from predictionio_tpu.cli.main import main as jax_main
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.storage import Event, Storage
from predictionio_tpu_torch.storage.wal import replay_wal_dir

ROOT = Path(__file__).resolve().parents[1]
MASKS = (
    (re.compile(r"[A-Za-z0-9_-]{24,64}"), "<KEY>"),  # generate_access_key
    (re.compile(r"\b[0-9a-f]{16}\b"), "<ID>"),       # engine instance ids
)


class Pair:
    """The JAX console and the port's on two scratch homes."""

    PKG = {"jax": "predictionio_tpu", "torch": "predictionio_tpu_torch"}

    def __init__(self, tmp_path, capsys):
        self.homes = {k: tmp_path / k for k in ("jax", "torch")}
        self.storage = {
            "jax": JaxStorage({"PIO_TPU_HOME": str(self.homes["jax"])}),
            "torch": Storage({"PIO_TPU_HOME": str(self.homes["torch"])}),
        }
        self.capsys = capsys

    def mask(self, out: str) -> str:
        for home in self.homes.values():
            out = out.replace(str(home), "<HOME>")
        out = out.replace("predictionio_tpu_torch", "predictionio_tpu")
        for pattern, repl in MASKS:
            out = pattern.sub(repl, out)
        return out

    def one(self, kind, *argv, device="cpu"):
        """(rc, masked stdout) of one console; ``{home}``, ``{pkg}`` and
        ``{kind}`` in an argument name that console's home, package and
        kind."""
        args = [a.format(home=self.homes[kind], pkg=self.PKG[kind],
                         kind=kind) for a in argv]
        if kind == "jax":
            rc = jax_main(args, storage=self.storage["jax"])
        else:
            rc = main(args, storage=self.storage["torch"], device=device)
        return rc, self.mask(self.capsys.readouterr().out)

    def run(self, *argv):
        """Both consoles on the same argv; asserts equal rc and stdout
        and returns them."""
        got = {k: self.one(k, *argv) for k in ("jax", "torch")}
        assert got["torch"] == got["jax"], argv
        return got["torch"]

    def close(self):
        for s in self.storage.values():
            s.close()


@pytest.fixture()
def pair(tmp_path, capsys):
    p = Pair(tmp_path, capsys)
    yield p
    p.close()


def test_app_lifecycle_equal(pair):
    rc, out = pair.run("app", "new", "myapp", "--description", "test app")
    assert rc == 0 and out == (
        "Created app 'myapp' (id 1).\nAccess key: <KEY>\n")
    pair.run("app", "new", "other", "--access-key", "fixedkey")
    assert pair.run("app", "list") == (
        0, "     1  myapp  keys=1\n     2  other  keys=1\n")
    rc, out = pair.run("app", "show", "other")
    assert "Access key: fixedkey events=(all)" in out
    assert pair.run("app", "new", "myapp")[0] == 1
    assert pair.run("app", "delete", "myapp") == (0, "Deleted app 'myapp'.\n")
    assert pair.run("app", "show", "myapp") == (
        1, "Error: app 'myapp' not found.\n")
    assert pair.run("app", "compact")[0] == 0


def test_channels_equal(pair):
    pair.run("app", "new", "capp")
    assert pair.run("app", "channel-new", "capp", "mobile") == (
        0, "Created channel 'mobile' (id 1).\n")
    assert "Channel: mobile (id 1)" in pair.run("app", "show", "capp")[1]
    assert pair.run("app", "channel-new", "capp", "bad name!")[0] == 1
    assert pair.run("app", "channel-new", "nope", "mobile")[0] == 1
    assert pair.run("app", "channel-delete", "capp", "nothere") == (
        1, "Error: channel 'nothere' not found.\n")
    assert pair.run("app", "channel-delete", "capp", "mobile") == (
        0, "Deleted channel 'mobile'.\n")


def test_accesskey_commands_equal(pair):
    pair.run("app", "new", "akapp")
    rc, out = pair.run("accesskey", "new", "akapp", "rate", "buy")
    assert rc == 0 and out == "Access key: <KEY>\n"
    assert pair.run("accesskey", "list", "akapp") == (0, (
        "<KEY>  appid=1  events=(all)\n<KEY>  appid=1  events=rate,buy\n"))
    assert pair.run("accesskey", "new", "nope")[0] == 1
    assert pair.run("accesskey", "list", "nope")[0] == 1
    assert pair.run("accesskey", "delete", "somekey") == (
        0, "Deleted access key somekey.\n")


def _seed(pair, app_name: str) -> None:
    old = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
    new = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
    rows = [("view", "u1", old), ("$set", "i1", old), ("view", "u2", new),
            ("buy", "u3", old)]
    for kind, cls in (("jax", JaxEvent), ("torch", Event)):
        st = pair.storage[kind]
        app = st.get_metadata().app_get_by_name(app_name)
        st.get_event_store().insert_batch([
            cls(event=name, entity_type="user" if name != "$set" else "item",
                entity_id=eid, event_time=t,
                **({} if name == "$set" else dict(
                    target_entity_type="item", target_entity_id="i1")),
                **({"properties": {"a": 1}} if name == "$set" else {}))
            for name, eid, t in rows], app.id)


def _count(pair, app_name: str) -> dict:
    out = {}
    for kind, st in pair.storage.items():
        app = st.get_metadata().app_get_by_name(app_name)
        out[kind] = sorted(e.event for e in
                           st.get_event_store().find(app_id=app.id))
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_trim_and_data_delete_equal(pair):
    pair.run("app", "new", "tapp")
    _seed(pair, "tapp")
    before = "2022-01-01T00:00:00.000Z"
    assert pair.run("app", "trim", "tapp")[0] == 1
    assert pair.run("app", "trim", "tapp", "--before", "not-a-time")[0] == 1
    assert pair.run("app", "trim", "tapp", "--before", before,
                    "--channel", "nope")[0] == 1
    assert pair.run("app", "trim", "tapp", "--before", before,
                    "--event", "buy") == (
        0, "Trimmed 1 events from app 'tapp'.\n")
    assert pair.run("app", "trim", "tapp", "--before", before) == (
        0, "Trimmed 1 events from app 'tapp'.\n")
    assert _count(pair, "tapp") == ["$set", "view"]
    assert pair.run("app", "trim", "tapp", "--before", before, "--all",
                    "--compact") == (
        0, "Trimmed 1 events from app 'tapp'.\n"
        "Compacted the event store (space reclaimed).\n")
    pair.run("app", "channel-new", "tapp", "web")
    assert pair.run("app", "data-delete", "tapp", "--channel", "web") == (
        0, "Deleted event data of app 'tapp'.\n")
    assert _count(pair, "tapp") == ["view"]
    assert pair.run("app", "data-delete", "tapp")[0] == 0
    assert _count(pair, "tapp") == []
    assert pair.run("app", "data-delete", "nope")[0] == 1


def test_import_export_roundtrip_equal(pair, tmp_path):
    pair.run("app", "new", "ioapp")
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{i}",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": i},
        "eventTime": f"2020-01-0{i + 1}T00:00:00.000Z"}) for i in range(3)))
    assert pair.run("import", "--appid", "1", "--input", str(src)) == (
        0, "Imported 3 events.\n")
    assert pair.run("export", "--appid", "1", "--output",
                    "{home}/out.jsonl") == (
        0, "Exported 3 events to <HOME>/out.jsonl.\n")
    exported = {}
    for kind, home in pair.homes.items():
        rows = [json.loads(ln) for ln in
                (home / "out.jsonl").read_text().splitlines()]
        for r in rows:
            r.pop("eventId"), r.pop("creationTime")
        exported[kind] = rows
    assert exported["torch"] == exported["jax"]
    assert [r["entityId"] for r in exported["torch"]] == ["u0", "u1", "u2"]
    # the columnar and Parquet formats: the written file is reported (an
    # npz name gains its extension), and each file imports back
    for argv, written in (
            (["--output", "{home}/x.npz"], "x.npz"),
            (["--format", "columnar", "--output", "{home}/y"], "y.npz"),
            (["--format", "parquet", "--output", "{home}/z.pq"], "z.pq")):
        assert pair.run("export", "--appid", "1", *argv) == (
            0, f"Exported 3 events to <HOME>/{written}.\n")
    for k, name in enumerate(("x.npz", "y.npz", "z.pq"), start=2):
        pair.run("app", "new", f"back{k}")
        assert pair.run("import", "--appid", str(k), "--input",
                        "{home}/" + name) == (0, "Imported 3 events.\n")
        # ids and creation times are each console's own import's
        back = {kind: sorted(json.dumps(
                    {**e.to_json(), "eventId": "", "creationTime": ""},
                    sort_keys=True)
                    for e in pair.storage[kind].get_event_store()
                    .find(app_id=k))
                for kind in pair.homes}
        assert back["torch"] == back["jax"]
        assert len(back["torch"]) == 3


def test_status_version_help_and_upgrade(pair):
    assert pair.run("version") == (0, f"pio-tpu {__version__}\n")
    assert pair.run("upgrade")[0] == 0
    rc = {}
    for kind in ("jax", "torch"):
        rc[kind], out = pair.one(kind, "status", "--probe-timeout", "0")
        lines = out.splitlines()
        assert lines[0] == "predictionio_tpu 0.3.0"
        assert "Storage: OK (metadata, event store, model data verified)" \
            in lines and lines[-1] == "Ready."
        if kind == "torch":
            assert "CUDA devices: probe skipped (--probe-timeout 0)" in lines
            assert any(ln.startswith("CUDA kernels: ") for ln in lines)
    assert rc == {"jax": 0, "torch": 0}
    helps = {k: pair.one(k, "help") for k in ("jax", "torch")}
    assert helps["torch"][0] == helps["jax"][0] == 0
    commands = {k: re.search(r"\{([a-z,-]+)\}", h[1]).group(1)
                for k, h in helps.items()}
    assert commands["torch"] == commands["jax"]


def test_undeploy_of_nothing_equal(pair):
    rc, out = pair.run("undeploy", "--port", "1")
    assert rc == 1 and out.startswith("Error: cannot undeploy 127.0.0.1:1: ")


REFUSED = [
    (["adminserver"], 9),
    (["dashboard"], 9),
]

# the multi-process train options are ported (a two-process console
# train: tests/test_torch_multiprocess_train.py); an incomplete set is
# an error before any work
PARTIAL_TRAIN = [
    ["train", "--coordinator", "127.0.0.1:1234"],
    ["train", "--num-processes", "2"],
]


class _Untouchable:
    """A storage whose every use fails the test: refusals come first."""

    def __getattr__(self, name):
        raise AssertionError(f"a refused command touched storage.{name}")


def test_every_unported_command_and_option_is_refused_first(capsys):
    for argv, item in REFUSED:
        rc = main(argv, storage=_Untouchable(), device="cpu")
        out = capsys.readouterr().out
        assert rc == 1, argv
        assert out.startswith("Error: ") and out.endswith(
            f"is not ported to predictionio_tpu_torch yet "
            f"(ROADMAP Queue 1 item {item})\n"), (argv, out)
    assert main(["eventserver", "--no-wal-fsync"], storage=_Untouchable(),
                device="cpu") == 1
    assert "fsyncs" in capsys.readouterr().out
    for argv in PARTIAL_TRAIN:
        with pytest.raises(ValueError, match="coordinator address"):
            main(argv, storage=_Untouchable(), device="cpu")


TENANT_FACTORY = ("predictionio_tpu_torch.templates.recommendation."
                  "recommendation_engine")


def test_deploy_multi_serves_every_tenant(pair, tmp_path):
    """``deploy --multi tenants.json --memory-budget B --autopilot on``
    in a thread on the CPU: each of three tenants (two variants of one
    app and a second app, each trained through ``train``) answers its
    query over HTTP, ``/debug/tenants`` shows the budget and the
    autopilot, ``/debug/experiments`` the controller, and ``undeploy``
    stops the server."""
    import threading
    import urllib.request

    st = pair.storage["torch"]
    tenants = []
    for app, variant, lam in (("shop", "control", 0.05),
                              ("shop", "treatment", 0.3),
                              ("news", "main", 0.1)):
        if st.get_metadata().app_get_by_name(app) is None:
            assert pair.one("torch", "app", "new", app)[0] == 0
            app_id = st.get_metadata().app_get_by_name(app).id
            st.get_event_store().insert_batch([
                Event(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties={"rating": float((u * i) % 5 + 1)})
                for u in range(8) for i in range(6) if (u + i) % 3], app_id)
        ej = tmp_path / f"{app}-{variant}.json"
        ej.write_text(json.dumps({
            "id": "multi", "engineFactory": TENANT_FACTORY,
            "datasource": {"params": {"appName": app}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 2, "lambda": lam}}]}))
        rc, out = pair.one("torch", "train", "--engine-json", str(ej))
        assert rc == 0, out
        tenants.append({"app": app, "variant": variant,
                        "engineJson": str(ej)})
    manifest = tmp_path / "tenants.json"
    manifest.write_text(json.dumps({"tenants": tenants}))
    pf = tmp_path / "multi.port"
    deploy = threading.Thread(target=main, args=([
        "deploy", "--multi", str(manifest), "--memory-budget", "1e9",
        "--autopilot", "on", "--ip", "127.0.0.1", "--port", "0",
        "--port-file", str(pf)],), kwargs=dict(storage=st, device="cpu"),
        daemon=True)
    deploy.start()
    port = None
    try:
        deadline = time.monotonic() + 60
        while not (pf.exists() and pf.read_text().endswith("\n")):
            assert time.monotonic() < deadline, "no port file"
            time.sleep(0.05)
        port = int(pf.read_text())

        def call(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=None if body is None else json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        for t in tenants:
            code, reply = call("/queries.json", {
                "user": "u1", "num": 3, "app": t["app"],
                "variant": t["variant"]})
            assert code == 200 and reply["variant"] == t["variant"]
            assert len(reply["itemScores"]) == 3
        code, dbg = call("/debug/tenants")
        assert code == 200 and dbg["tenants"] == 3 and dbg["resident"] == 3
        assert dbg["memoryBudgetBytes"] == 10 ** 9
        assert dbg["autopilot"] is not None
        code, exp = call("/debug/experiments")
        assert code == 200 and exp["enabled"] is True
        assert sorted(exp["weights"]) == ["news", "shop"]
    finally:
        if port is not None:
            rc, out = pair.one("torch", "undeploy", "--port", str(port))
            assert rc == 0, out
        deploy.join(timeout=30)
    assert not deploy.is_alive()


def _env(home):
    return {**os.environ, "PIO_TPU_HOME": str(home),
            "PYTHONPATH": str(ROOT)}


def test_the_console_runs_as_a_module():
    p = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch",
                        "version"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert (p.returncode, p.stdout) == (0, f"pio-tpu {__version__}\n")


def test_eventserver_process_takes_events(pair, tmp_path):
    rc, out = pair.one("torch", "app", "new", "esapp", "--access-key", "k1")
    assert rc == 0
    pair.storage["torch"].close()
    pf = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch", "eventserver",
         "--ip", "127.0.0.1", "--port", "0", "--port-file", str(pf),
         "--wal-dir", str(tmp_path / "wal")],
        env=_env(pair.homes["torch"]), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while not pf.exists() and proc.poll() is None:
            assert time.monotonic() < deadline, "no port file"
            time.sleep(0.05)
        assert proc.poll() is None, proc.stdout.read()
        c = http.client.HTTPConnection("127.0.0.1", int(pf.read_text()),
                                       timeout=30)
        c.request("POST", "/batch/events.json?accessKey=k1", json.dumps([
            {"event": "rate", "entityType": "user", "entityId": f"u{k}",
             "targetEntityType": "item", "targetEntityId": "i1",
             "properties": {"rating": 4.0}} for k in range(3)]))
        r = c.getresponse()
        assert r.status == 200
        assert [e["status"] for e in json.loads(r.read())] == [201] * 3
        c.close()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "Event server running on 127.0.0.1:" in out
    # every acknowledged event survives the kill: committed, or in the
    # WAL that the next boot replays
    st = Storage({"PIO_TPU_HOME": str(pair.homes["torch"])})
    try:
        es = st.get_event_store()
        replay_wal_dir(tmp_path / "wal", es)
        assert len(list(es.find(app_id=1))) == 3
    finally:
        st.close()
