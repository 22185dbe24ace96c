"""The port's launchers under ``bin/``: ``pio-tpu-torch`` (the console),
``pio-tpu-torch-shell``, ``-daemon``, ``-start-all`` and ``-stop-all``,
each run as a user runs it, against a scratch ``$PIO_TPU_HOME``.

The two packages share one ``$PIO_TPU_HOME``, and the reference's
``bin/pio-tpu-stop-all`` stops every pid file directly under its
``run/``: the port's daemons keep theirs in ``run/torch/``, and the
port's stop-all touches nothing else.
"""

import os
import signal
import socket
import subprocess
import time
import urllib.request
from pathlib import Path

import pytest

BIN = Path(__file__).resolve().parents[1] / "bin"


def _env(home: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_TPU_"))}
    env.update(PIO_TPU_HOME=str(home), **extra)
    return env


def _run(cmd: list, env: dict, stdin: str = "", timeout: float = 120):
    return subprocess.run(cmd, env=env, input=stdin, capture_output=True,
                          text=True, timeout=timeout)


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie left by an exited child is not running
    stat = Path(f"/proc/{pid}/stat")
    return not (stat.exists() and stat.read_text().split()[2] == "Z")


def test_console_app_new_and_list(tmp_path):
    env = _env(tmp_path / "home")
    out = _run([str(BIN / "pio-tpu-torch"), "app", "new", "shop"], env)
    assert out.returncode == 0, out.stderr
    assert "Created app 'shop' (id 1)." in out.stdout
    assert "Access key: " in out.stdout
    out = _run([str(BIN / "pio-tpu-torch"), "app", "list"], env)
    assert out.returncode == 0, out.stderr
    assert "shop" in out.stdout and "keys=1" in out.stdout
    # the app lives in the scratch home's metadata store
    assert any((tmp_path / "home").iterdir())


def test_shell_binds_the_ports_storage(tmp_path):
    env = _env(tmp_path / "home")
    out = _run([str(BIN / "pio-tpu-torch-shell")], env, stdin=(
        "print('module', type(storage).__module__)\n"
        "print('home', storage.env['PIO_TPU_HOME'])\n"
        "print('dsl', Engine.__module__, WorkflowContext.__module__)\n"
        "import sys\n"
        "print('jax', any(m.split('.')[0] in ('jax', 'predictionio_tpu')"
        " for m in sys.modules))\n"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split(">>> ")
    assert "predictionio_tpu_torch 0.3.0 shell" in lines[0]
    text = out.stdout
    assert "module predictionio_tpu_torch.storage.registry" in text
    assert f"home {tmp_path / 'home'}" in text
    assert ("dsl predictionio_tpu_torch.controller.engine "
            "predictionio_tpu_torch.controller.base") in text
    assert "jax False" in text


def test_daemon_needs_a_pidfile_and_a_command(tmp_path):
    out = _run([str(BIN / "pio-tpu-torch-daemon"), "x.pid"],
               _env(tmp_path / "home"))
    assert out.returncode == 1
    assert "usage: pio-tpu-torch-daemon" in out.stderr


def test_start_all_and_stop_all_keep_to_run_torch(tmp_path):
    """start-all's three servers answer ``GET /`` on the ports the
    environment names, with their pid files in ``run/torch/``; stop-all
    stops them all and spares a pid file of the reference's ``run/`` and
    its process."""
    home = tmp_path / "home"
    ports = {"EVENTSERVER": _free_port(), "ADMINSERVER": _free_port(),
             "DASHBOARD": _free_port()}
    env = _env(home, PIO_TPU_EVENTSERVER_IP="127.0.0.1",
               **{f"PIO_TPU_{k}_PORT": str(p) for k, p in ports.items()})
    run = home / "run"
    run.mkdir(parents=True)
    bystander = subprocess.Popen(["sleep", "120"])
    (run / "eventserver.pid").write_text(f"{bystander.pid}\n")
    try:
        out = _run([str(BIN / "pio-tpu-torch-start-all")], env)
        assert out.returncode == 0, out.stderr
        pidfiles = sorted(p.name for p in (run / "torch").glob("*.pid"))
        assert pidfiles == ["adminserver.pid", "dashboard.pid",
                            "eventserver.pid"]
        pids = [int((run / "torch" / f).read_text()) for f in pidfiles]
        deadline = time.monotonic() + 90
        for name, port in ports.items():
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/", timeout=5) as r:
                        assert r.status == 200, name
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        logs = {p.name: p.read_text()[-2000:]
                                for p in (run / "torch").glob("*.log")}
                        pytest.fail(f"{name} never answered: {logs}")
                    time.sleep(0.2)
        out = _run([str(BIN / "pio-tpu-torch-stop-all")], env)
        assert out.returncode == 0, out.stderr
        for name in ("adminserver", "dashboard", "eventserver"):
            assert f"stopped {name}" in out.stdout
        deadline = time.monotonic() + 30
        while any(_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(p) for p in pids)
        assert not list((run / "torch").glob("*.pid"))
        # the reference's pid file and its process are untouched
        assert (run / "eventserver.pid").read_text() == f"{bystander.pid}\n"
        assert bystander.poll() is None
        out = _run([str(BIN / "pio-tpu-torch-stop-all")], env)
        assert "nothing to stop" in out.stdout
    finally:
        for p in (run / "torch").glob("*.pid"):
            try:
                os.kill(int(p.read_text()), signal.SIGKILL)
            except (ProcessLookupError, ValueError):
                pass
        bystander.kill()
        bystander.wait()
