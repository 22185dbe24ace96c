"""Coded (parity) factor shards: straggler tolerance for sharded ALS.

Port of ``predictionio_tpu/parallel/coded.py`` (coded ALS, arXiv
2105.03631, on the ALX-style sharded placement, arXiv 2112.02194).
Beside the ``d`` row blocks of a sharded factor table the trainer keeps
one parity block, the elementwise sum of the blocks, so any one block
is recoverable from the other ``d - 1``::

    block_i = parity - sum_{j != i} block_j

and a half-iteration whose ``i``-th shard is late or dead completes from
the survivors.

* Device math: :func:`build_parity_fn` (the block sum) and
  :func:`build_coded_gather` (the all-gather with dead blocks rebuilt
  in the same pass), over the mesh's per-shard tensors.
* Host orchestration: :class:`ShardHealth` consults the ``dist.*``
  fault points (``resilience/faults.fired_shard``) and the hop budget,
  answers the ``[d]`` ok-mask, books ``pio_shard_degraded_total{shard}``,
  ``pio_shard_lag_seconds`` and a ``dist.parity_serve`` span, and
  remembers kills.  Two holes at once raise :class:`ParityExhausted`.

As in the reference's in-process mesh, the parity block is held
replicated (one copy per shard device).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..obs import SHARD_DEGRADED_TOTAL, SHARD_LAG_SECONDS, get_tracer, tower
from ..resilience import faults
from .collectives import gather_shards, psum
from .mesh import Mesh

logger = logging.getLogger(__name__)

__all__ = [
    "ParityExhausted",
    "ShardHealth",
    "build_coded_gather",
    "build_parity_fn",
    "coded_blocks",
]


class ParityExhausted(RuntimeError):
    """More shards are missing than the parity code can reconstruct."""


def build_parity_fn(mesh: Mesh):
    """``fn(parts) -> [S, R]`` f32 parity (block sum), replicated."""

    def parity(parts) -> list:
        return psum([p.float() for p in parts], mesh)

    return parity


def coded_blocks(parts, send, parity, ok, mesh: Mesh) -> tuple:
    """``(blocks, recon)``: every block of the table, in shard order,
    on this process's first shard device, with each masked block rebuilt
    from parity, and the f32 rebuilt block itself.

    ``parts`` are the local blocks, ``send`` the same blocks in the
    dtype they travel in (bf16 in bf16 gather mode), ``parity`` the
    replicated f32 block sum and ``ok`` the ``[d]`` 0/1 mask.  The
    alive sum rides f32 so a bf16 gather does not erode the rebuild;
    with every shard alive the rebuilt block is multiplied by zero."""
    okm = [float(ok[s]) for s in mesh.local]
    blocks = gather_shards([s * m for s, m in zip(send, okm)], mesh)
    alive = psum([p.float() * m for p, m in zip(parts, okm)], mesh)
    recon = parity[0].to(alive[0].device) - alive[0]
    rb = recon.to(blocks[0].dtype)
    return [b * float(ok[s]) + rb * (1.0 - float(ok[s]))
            for s, b in enumerate(blocks)], recon


def build_coded_gather(mesh: Mesh):
    """``fn(parts, parity, ok) -> [M, R]`` replicated: the full table
    with any masked (late/dead) block rebuilt as ``parity - sum(alive)``
    (exact while parity is current).  With an all-ones mask the result
    is the plain all-gather."""

    def gather(parts, parity, ok) -> list:
        full = torch.cat(coded_blocks(parts, parts, parity, ok, mesh)[0])
        return [full.to(d) for d in mesh.devices]

    return gather


def _fire(point: str, max_wait: float = 0.0):
    return faults.fired_shard(point, max_wait=max_wait)


class ShardHealth:
    """Host-side shard liveness for one coded run.

    Per half-iteration the trainer calls :meth:`poll`, which consults
    the three ``dist.*`` shard points and answers the ``[d]`` ok-mask:

    * ``dist.worker_kill``: the shard is dead from now on (sticky);
    * ``dist.shard_drop``: the shard is out for this poll only;
    * ``dist.shard_delay``: the shard is slow; with a hop budget
      (``hop_budget_s``, or a request deadline split per hop) a lag
      within it is waited for, past it (or with no budget) the shard is
      served from parity.

    Every degradation books ``pio_shard_degraded_total{shard}``,
    observes the lag in ``pio_shard_lag_seconds{op}``, records a
    ``dist.parity_serve`` span and notes the event in the tower
    session.  Parity ownership rotates per poll."""

    def __init__(self, n_shards: int, hop_budget_s: Optional[float] = None,
                 op: str = "als.half"):
        if n_shards < 2:
            raise ValueError("coded shards need a mesh of >= 2 devices")
        self.n_shards = n_shards
        self.hop_budget_s = hop_budget_s
        self.op = op
        self.killed: set[int] = set()
        self.degraded_polls = 0
        self.parity_owner = 0
        self._polls = 0

    def poll(self, deadline=None) -> np.ndarray:
        """The ``[d]`` f32 ok-mask for the next coded call (1 = on time,
        0 = serve from parity); raises :class:`ParityExhausted` when
        more than one shard is down."""
        self._polls += 1
        self.parity_owner = (self._polls - 1) % self.n_shards
        degraded: dict[int, float] = {}

        hit = _fire("dist.worker_kill")
        if hit is not None:
            k, lag = hit
            k %= self.n_shards
            if k not in self.killed:
                logger.warning(
                    "shard %d killed (fault plan); serving from parity "
                    "for the rest of the run", k,
                )
            self.killed.add(k)
            degraded[k] = lag
        for k in self.killed:
            degraded.setdefault(k, 0.0)

        hit = _fire("dist.shard_drop")
        if hit is not None:
            s, lag = hit
            degraded[s % self.n_shards] = lag

        budget = self.hop_budget_s
        if deadline is not None:
            rem = max(deadline.remaining(), 0.0)
            per_hop = rem / max(self.n_shards, 1)
            budget = per_hop if budget is None else min(budget, per_hop)
        hit = _fire("dist.shard_delay", max_wait=budget or 0.0)
        if hit is not None:
            s, lag = hit
            s %= self.n_shards
            if budget is None or lag > budget:
                degraded[s] = lag
            else:
                # late but within its hop budget: tolerated, the lag kept
                SHARD_LAG_SECONDS.labels(op=self.op).observe(lag)

        if len(degraded) > 1:
            raise ParityExhausted(
                f"shards {sorted(degraded)} are all missing; a single "
                "parity block reconstructs at most one — rebuild the "
                "table or widen the code before continuing"
            )

        ok = np.ones(self.n_shards, np.float32)
        for shard, shard_lag in degraded.items():
            ok[shard] = 0.0
            self.degraded_polls += 1
            SHARD_DEGRADED_TOTAL.labels(shard=str(shard)).inc()
            SHARD_LAG_SECONDS.labels(op=self.op).observe(shard_lag)
            get_tracer().record(
                "dist.parity_serve", shard_lag,
                attrs={"shard": shard, "op": self.op,
                       "sticky": shard in self.killed},
            )
            tower.note_shard_event({
                "shard": shard, "lagSeconds": round(shard_lag, 6),
                "op": self.op, "sticky": shard in self.killed,
            })
        return ok

    def summary(self) -> dict:
        """The status view of the shard health."""
        return {
            "shards": self.n_shards,
            "killed": sorted(self.killed),
            "degradedPolls": self.degraded_polls,
            "parityOwner": self.parity_owner,
        }
