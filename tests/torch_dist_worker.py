"""One process of a multi-process run of the port, for the tests.

``python tests/torch_dist_worker.py JOB.json``: the job names the run
(``addr`` host:port of process 0, ``n`` processes, this ``rank``), the
``kind`` of work and an ``out`` path this process writes its results to
(an ``.npz``).  It joins the gloo process group on the CPU and never
imports JAX; the tests compare what it writes with the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _mesh(job):
    from predictionio_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cpu"] * job.get("shards_per_proc", 1))


def collectives(job) -> dict:
    from predictionio_tpu_torch.parallel import collectives as C
    from predictionio_tpu_torch.parallel.mesh import shard_put

    mesh = _mesh(job)
    d = mesh.size
    x = np.arange(d * d * 3, dtype=np.float32)
    parts = np.stack([np.full((16,), s, np.float32) for s in range(d)])
    return {
        "size": np.int64(d),
        "lo": np.int64(mesh.lo),
        "all_reduce_sum": C.all_reduce_sum(shard_put(x, mesh), mesh)[0]
        .numpy(),
        "all_gather_blocks": C.all_gather_blocks(shard_put(x, mesh),
                                                 mesh)[0].numpy(),
        "all_to_all_blocks": torch.cat(C.all_to_all_blocks(
            shard_put(x, mesh), mesh)).numpy(),
        "reduce_scatter_sum": torch.cat(C.reduce_scatter_sum(
            shard_put(parts, mesh), mesh)).numpy(),
        "ring_shift": torch.cat(C.ring_shift(shard_put(x, mesh), mesh))
        .numpy(),
    }


def trainer(job) -> dict:
    """ALSTrainer.distributed over this process's share of the triples
    (rows with ``user % n == rank``), from the injected start."""
    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer

    data = np.load(job["data"])
    u, i, v = data["u"], data["i"], data["v"]
    n, rank = job["n"], job["rank"]
    keep = (u % n) == rank
    cfg = ALSConfig(**job["cfg"])
    mesh = _mesh(job)
    tr = ALSTrainer.distributed(
        (u[keep], i[keep], v[keep]), int(data["n_users"]),
        int(data["n_items"]), cfg=cfg, mesh=mesh,
        exchange_dir=job["exchange_dir"], tag="t",
    )
    f = tr.train(init=(torch.from_numpy(data["U0"]),
                       torch.from_numpy(data["V0"])))
    return {"U": f.user_factors, "V": f.item_factors,
            "staging": np.asarray(tr.staging),
            "coo_shard_entries": np.int64(tr.coo_shard_entries)}


def exchange(job) -> dict:
    """ids_exchange and the owner exchange (its torn retry under the
    job's fault plan)."""
    from predictionio_tpu_torch.parallel.ingest import (
        exchange_ratings_by_owner,
        ids_exchange,
    )

    rank, n = job["rank"], job["n"]
    idx = ids_exchange([f"u{rank}", f"u{rank + 10}", "shared"],
                       job["exchange_dir"], "ids")
    r = np.arange(12, dtype=np.int64) + 100 * rank
    c = np.arange(12, dtype=np.int64)
    owner = np.arange(100 * n + 12) % n
    r2, c2, v2 = exchange_ratings_by_owner(
        r, c, r.astype(np.float32), owner, job["exchange_dir"], "coo")
    return {"ids": np.asarray(list(idx.ids), str), "r": r2, "c": c2,
            "v": v2}


def cli(job) -> dict:
    """``train --coordinator`` through the console, on the store of
    ``$PIO_TPU_HOME``."""
    from predictionio_tpu_torch.cli.main import main

    rc = main(job["argv"] + [
        "--coordinator", job["addr"], "--num-processes", str(job["n"]),
        "--process-id", str(job["rank"])], device="cpu")
    return {"rc": np.int64(rc)}


def run(job) -> None:
    from predictionio_tpu_torch.parallel.mesh import (
        distributed_init,
        distributed_shutdown,
    )

    torch.set_num_threads(1)
    if job["kind"] != "cli":
        distributed_init(job["addr"], job["n"], job["rank"], device="cpu")
    try:
        out = globals()[job["kind"]](job)
    finally:
        distributed_shutdown()
    np.savez(job["out"], **out)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(tmp, jobs: list, timeout: float = 120.0, env=None) -> list:
    """Run one worker process per job (rank = position), join them under
    ``timeout`` seconds and kill them all on expiry; returns each
    process's results.  A failed or hung worker fails the caller with
    its log."""
    import subprocess
    import time

    tmp = Path(tmp)
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    for rank, job in enumerate(jobs):
        job = dict(job, addr=addr, n=len(jobs), rank=rank,
                   out=str(tmp / f"out-{rank}.npz"))
        path = tmp / f"job-{rank}.json"
        path.write_text(json.dumps(job))
        log = open(tmp / f"log-{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(path)], stdout=log,
            stderr=subprocess.STDOUT, env={**os.environ, **(env or {})},
        ), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "\n".join((tmp / f"log-{r}.txt").read_text()[-3000:]
                         for r in bad)
        raise AssertionError(f"workers {bad} failed or hung:\n{logs}")
    return [dict(np.load(tmp / f"out-{r}.npz")) for r in range(len(jobs))]


if __name__ == "__main__":
    run(json.loads(Path(sys.argv[1]).read_text()))
    os._exit(0)
