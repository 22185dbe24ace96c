"""A process that served ``GET /debug/profile`` exits cleanly, every time.

The capture (``obs/timeline.py`` ``capture_profile``) is asked for by a
request thread of the server, not the process's main thread.  Each of
:data:`RUNS` fresh interpreters here first traces a block on its main
thread (``utils.profile_trace`` around a host step, as a workflow
does), then serves one
capture the way a server does (a threads-edge
``CappedThreadingHTTPServer`` answering the observability mounts, while
three threads launch kernels inside ``timeline.annotate`` scopes, as
the micro-batcher's dispatcher does), checks that the trace names a
CUDA kernel, stops the server and exits the way the console does
(``timeline.exit_process``) while those threads still launch kernels;
every exit code must be 0.  A process cannot catch an abort at its own
exit, which is why each run is a subprocess.

The test needs an NVIDIA GPU and skips without one.  Run it on the card
with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_profile_exit.py
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
RUNS = 10
TIMEOUT_S = 120

CHILD = """
import json, sys, threading, urllib.request
import torch
from predictionio_tpu_torch.obs import timeline
from predictionio_tpu_torch.server.http_base import (
    CappedThreadingHTTPServer, JsonRequestHandler)
from predictionio_tpu_torch.utils import profile_trace

a = torch.randn(512, 512, device="cuda")
# a workflow's own trace of a host step, on the main thread, first
with profile_trace("boot", enabled=True):
    sum(range(1000))
stop = threading.Event()

def busy():
    while not stop.is_set():
        with timeline.annotate("pio.device.batch"):
            (a @ a).sum().item()

workers = [threading.Thread(target=busy, daemon=True) for _ in range(3)]
for w in workers:
    w.start()

class Handler(JsonRequestHandler):
    def do_GET(self):
        if not self._serve_metrics():
            self._reply(404, {"message": "not found"})

srv = CappedThreadingHTTPServer(("127.0.0.1", 0), Handler)
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}/debug/profile?seconds=0.3"
with urllib.request.urlopen(url, timeout=120) as r:
    out = json.loads(r.read())
srv.shutdown()
srv.server_close()
print(json.dumps({"kernels": len(out["cudaKernels"])}))
# the console's way out (python -m predictionio_tpu_torch), with the
# kernel threads still running, as a deploy's are at its undeploy
timeline.exit_process(0)
"""


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the capture must see the card")
    return torch.device("cuda")


def test_every_process_that_served_a_capture_exits_0(dev, tmp_path):
    """Each run's exit code (``"hung"`` past :data:`TIMEOUT_S`); all must
    be 0, each capture naming a CUDA kernel."""
    rcs, errs = [], []
    for k in range(RUNS):
        try:
            p = subprocess.run(
                [sys.executable, "-c", CHILD], cwd=ROOT,
                capture_output=True, text=True, timeout=TIMEOUT_S,
                env={**os.environ, "PYTHONPATH": str(ROOT),
                     "PIO_TPU_HOME": str(tmp_path / f"home{k}")})
        except subprocess.TimeoutExpired as e:
            rcs.append("hung")
            errs.append(str(e.stderr)[-2000:])
            continue
        rcs.append(p.returncode)
        if p.returncode != 0:
            errs.append(p.stderr[-2000:])
        else:
            assert '"kernels": 0' not in p.stdout, p.stdout
    print(f"exit codes of {RUNS} runs: {rcs}")
    assert rcs == [0] * RUNS, (rcs, errs[:1])
