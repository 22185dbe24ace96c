"""What the tests of the port's examples share: both engines of an
example loaded side by side, the two packages' memory stores, the JAX
trainer's initial factors carried into the port's trainer, and the
comparisons with their tolerances.

Each example directory holds the reference's ``engine.py`` and the
port's ``engine_torch.py``; they are imported as the console imports an
engine (the directory on ``sys.path`` and as the working directory, so
the data files resolve where they are), under their own module names,
and everything is put back afterwards.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from predictionio_tpu.controller import WorkflowContext as JaxContext
from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.convert import factors_from_jax
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.storage import Storage

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# ALS parity (the tolerances of tests/test_torch_als.py): from the same
# initial factors each half's factors within 1e-4 of their scale, the
# training RMSE within 1e-5 relative, top-K ids equal outside ties
FACTOR_TOL = 1e-4
RMSE_TOL = 1e-5
# scores of a served answer, and what counts as a tie among them
SCORE_TOL = 1e-4

MEMORY = {
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEMDB",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_SOURCES_MEMDB_TYPE": "memory",
}


@contextlib.contextmanager
def example(name: str):
    """``(engine, engine_torch)`` of ``examples/<name>``, with the
    example's directory as the working directory until the block ends."""
    d = str(EXAMPLES / name)
    old_cwd = os.getcwd()
    os.chdir(d)
    sys.path.insert(0, d)
    try:
        for mod in ("engine", "engine_torch"):
            sys.modules.pop(mod, None)
        yield (importlib.import_module("engine"),
               importlib.import_module("engine_torch"))
    finally:
        os.chdir(old_cwd)
        if d in sys.path:
            sys.path.remove(d)
        for mod in ("engine", "engine_torch"):
            sys.modules.pop(mod, None)


def variant(path: str = "engine.json") -> dict:
    return json.loads(Path(path).read_text())


def contexts(**kw) -> tuple:
    """A JAX context and a port context on the host, each on a memory
    store of its own package."""
    return (JaxContext(storage=JaxStorage(env=MEMORY), **kw),
            WorkflowContext(device="cpu", storage=Storage(env=MEMORY), **kw))


def train_both(ref, port, name: str = "engine.json", port_ctx=None):
    """Train the reference's engine on its ``engine.json`` and the port's
    on ``engine_torch.json``; ``(engine, params, models)`` of each."""
    jctx, pctx = contexts()
    out = []
    for mod, ej, ctx in ((ref, name, jctx),
                         (port, name.replace("engine", "engine_torch"),
                          port_ctx or pctx)):
        engine = mod.engine_factory()
        ep = engine.params_from_variant(variant(ej))
        out.append((engine, ep, engine.train(ctx, ep)))
    return out


_INITS: dict = {}


def jax_initial_factors(n_users: int, n_items: int, rank: int,
                        seed: int) -> tuple:
    """The JAX trainer's ``init_factors`` for a table shape (host
    arrays); the draw depends on nothing else."""
    key = (n_users, n_items, rank, seed)
    if key not in _INITS:
        z = np.zeros(1, np.int32)
        jt = JaxALSTrainer((z, z, np.ones(1, np.float32)), n_users,
                           n_items, JaxALSConfig(rank=rank, seed=seed))
        _INITS[key] = tuple(np.asarray(a) for a in jt.init_factors())
    return _INITS[key]


def start_from_jax(monkeypatch) -> None:
    """Every port trainer starts from the JAX trainer's initial factors
    of its own shape (zero-padded rows under sharded placement, as the
    reference pads them)."""

    def init_factors(self):
        U0, V0 = jax_initial_factors(self.n_users, self.n_items,
                                     self.cfg.rank, self.cfg.seed)
        if self.sharded:
            U0 = np.pad(U0, ((0, self._pad_users - self.n_users), (0, 0)))
            V0 = np.pad(V0, ((0, self._pad_items - self.n_items), (0, 0)))
        return factors_from_jax(U0, V0, self.device)

    monkeypatch.setattr(port_als.ALSTrainer, "init_factors", init_factors)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rmse(U, V, u, i, v) -> float:
    """Training RMSE of factor tables over COO triples (float64)."""
    U, V = np.asarray(U, np.float64), np.asarray(V, np.float64)
    pred = (U[np.asarray(u)] * V[np.asarray(i)]).sum(-1)
    return float(np.sqrt(np.mean((pred - np.asarray(v, np.float64)) ** 2)))


def same_als(got: tuple, want: tuple, triples) -> None:
    """``(U, V)`` of the port against the reference's: each half within
    :data:`FACTOR_TOL` of its scale, the training RMSE over ``triples``
    (user, item, value) within :data:`RMSE_TOL` relative."""
    assert rel_err(got[0], want[0]) <= FACTOR_TOL
    assert rel_err(got[1], want[1]) <= FACTOR_TOL
    g, w = rmse(*got, *triples), rmse(*want, *triples)
    assert abs(g - w) <= RMSE_TOL * w, (g, w)


def same_ranking(got: list, want: list, tol: float = SCORE_TOL) -> None:
    """``[(id, score)]`` answers of the two packages: the same length,
    scores within ``tol`` of the scale, and the same id at every
    position but where the two ids' scores tie (within ``tol``) in the
    reference's answer — or the port's id lies past its end on a tie
    with its last score."""
    assert len(got) == len(want), (got, want)
    if not want:
        return
    scale = max(abs(s) for _, s in want) or 1.0
    for (gi, gs), (wi, ws) in zip(got, want):
        assert abs(gs - ws) <= tol * scale, (got, want)
        if gi != wi:
            tied = dict(want).get(gi, want[-1][1])
            assert abs(tied - ws) <= tol * scale, (got, want)


def one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
