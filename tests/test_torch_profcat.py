"""``python -m predictionio_tpu_torch.tools.profcat`` against the
reference's ``tools/profcat.py`` on the same inputs: the same printed
table and root split, the same ``--out`` file, the same ``--diff`` view
and the same ``--html`` page, from ``.folded`` files and from a fleet
found through a router's ``GET /`` (serving ``replicas`` or ingest
``workers``) — stub servers answering ``/`` and ``/debug/pprof`` here.
The port's command imports no torch (``tests/test_torch_imports.py``).
"""

import contextlib
import importlib.util
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from predictionio_tpu_torch.obs import scope
from predictionio_tpu_torch.tools import profcat

ROOT = Path(__file__).resolve().parents[1]

A = ("eventloop;server.py:serve;handler.py:predict 40\n"
     "eventloop;server.py:serve;json.py:dumps 7\n"
     "microbatch_dispatcher;microbatch.py:run;topk.py:topk 25\n"
     "main;threading.py:wait 3\n")
B = ("eventloop;server.py:serve;handler.py:predict 22\n"
     "health_loop;router.py:poll 9\n"
     "microbatch_dispatcher;microbatch.py:run;topk.py:topk 31\n")


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "reference_profcat", ROOT / "tools" / "profcat.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(reference, capsys, tmp_path, argv: list) -> list:
    """Run each tool on ``argv`` (``{out}``/``{html}`` name files of its
    own); its stdout with those names put back, and the files."""
    runs = []
    for kind, mod in (("ref", reference), ("port", profcat)):
        out, html = tmp_path / f"{kind}.folded", tmp_path / f"{kind}.html"
        rc = mod.main([a.format(out=out, html=html) for a in argv])
        text = capsys.readouterr().out
        text = text.replace(str(out), "{out}").replace(str(html), "{html}")
        runs.append((rc, text,
                     out.read_text() if out.exists() else None,
                     html.read_text() if html.exists() else None))
    return runs


def test_files_table_out_and_html(reference, capsys, tmp_path):
    a, b = tmp_path / "a.folded", tmp_path / "b.folded"
    a.write_text(A)
    b.write_text(B)
    ref, port = _both(reference, capsys, tmp_path, [
        str(a), str(b), "--top", "4", "--out", "{out}", "--html", "{html}"])
    assert port == ref
    rc, text, folded, html = port
    assert rc == 0
    total = sum(scope.parse_folded(A).values()) + sum(
        scope.parse_folded(B).values())
    assert f"# 2 profile(s), {total} samples" in text
    # the roots are tagged by source, and the file's total is the table's
    merged = scope.parse_folded(folded)
    assert sum(merged.values()) == total
    assert {s.split("/", 1)[0] for s in merged} == {"a", "b"}
    assert html.startswith("<!doctype html>")


def test_diff_against_a_baseline_file(reference, capsys, tmp_path):
    a, b = tmp_path / "a.folded", tmp_path / "b.folded"
    a.write_text(A)
    b.write_text(B)
    ref, port = _both(reference, capsys, tmp_path, [
        str(b), "--diff", str(a), "--no-tag", "--html", "{html}"])
    assert port == ref
    assert "# share delta vs baseline (by root):" in port[1]
    assert "#   health_loop: +" in port[1]
    ref, port = _both(reference, capsys, tmp_path, [
        str(b), "--diff", str(tmp_path / "missing.folded")])
    assert port[0] == ref[0] == 1
    # no source at all is a usage error in both
    for mod in (reference, profcat):
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code == 2
        assert "no sources" in capsys.readouterr().err


@contextlib.contextmanager
def _servers(folded: list, status_key: str):
    """A router stub (its own profile, and ``GET /`` naming the others
    under ``status_key``) and one stub per further profile."""
    servers = []

    def handler(text: str, status=None):
        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/debug/pprof?seconds=1"):
                    body = text.encode()
                elif self.path == "/" and status is not None:
                    body = json.dumps(status()).encode()
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        return H

    def members():
        return {status_key: [{"url": f"http://127.0.0.1:{s.server_port}"}
                             for s in servers[1:]] + [{"name": "down"}]}

    try:
        for k, text in enumerate(folded):
            srv = ThreadingHTTPServer(("127.0.0.1", 0), handler(
                text, members if k == 0 else None))
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
        yield [f"http://127.0.0.1:{s.server_port}" for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


@pytest.mark.parametrize("status_key", ["replicas", "workers"])
def test_fleet_discovery(reference, capsys, tmp_path, status_key):
    texts = ["router;router.py:forward 5\n", A, B]
    with _servers(texts, status_key) as urls:
        ref, port = _both(reference, capsys, tmp_path, [
            "--fleet", urls[0], "--seconds", "1", "--out", "{out}"])
        assert port == ref
        rc, text, folded, _ = port
        assert rc == 0
        merged = scope.parse_folded(folded)
        roots = {s.split("/", 1)[0] for s in merged}
        assert roots == {u.rsplit(":", 1)[1] for u in urls}
        total = sum(sum(scope.parse_folded(t).values()) for t in texts)
        assert sum(merged.values()) == total
        assert f"# 3 profile(s), {total} samples" in text
        assert profcat.discover_fleet(urls[0], 5.0) == urls
