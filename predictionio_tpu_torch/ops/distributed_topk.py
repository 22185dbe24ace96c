"""Ring top-k scoring over a mesh-sharded item table.

Port of ``predictionio_tpu/ops/distributed_topk.py``.  Serving's hot op
is ``scores = U @ V.T`` + top-k (`ops/topk.py`).  When the item table
lives sharded over the mesh (``parallel/mesh.py``: shard ``s`` is the
``s``-th contiguous row block, on its shard's device), this op keeps
every shard where it is and rotates them around the ring instead (the
ring-matmul schedule): at each of the ``d`` hops the query block is
scored against the shard passing through, the result is folded into a
running top-k, and the shard, its row bias and its owner id move on to
the next position (``parallel/collectives.py`` ``ring_shift``).  Nothing
is ever built at ``[B, M]``: a hop scores ``[B, M/d]``.

The reference runs the ring as one ``shard_map`` program in which every
device folds every shard, so its answer is replicated by construction;
here each process folds the shards passing through its first local
position (the others would fold the same shards), so one process with
``d`` shards on one card does ``d`` products, not ``d * d``.  The hops'
products and top-ks are torch ops (``torch.matmul`` in true f32 and the
``lax.top_k`` order of ``ops/topk.py``); the reference's ring is XLA, not
a Pallas kernel.

**Straggler tolerance.**  With the table's ``parity`` block (the block
sum, ``parallel/coded.py``) each call polls the ``dist.*`` fault points
and a per-shard budget, the request
:class:`~predictionio_tpu_torch.resilience.Deadline` in scope split per
hop.  A shard that misses its budget is scored from its parity
reconstruction (``parity - sum(alive)``) inside the same call, and
``pio_shard_degraded_total{shard}`` books it.

**The int8 candidate stage.**  With an int8 copy of the shards and
their per-row scales (``ops/ann.py`` ``quantize_rows``), each hop scans
the passing shard's int8 rows first, shortlists the ``candidate_k``
local candidates and reranks only those from the f32 shard.  It never
composes with the coded variant: :class:`ShardedTopK` sends a degraded
call to the coded exact ring, as the reference does.

:class:`ShardedTopK` packages the serving-side lifecycle: pad and shard
the item table, build parity once, keep one sticky
:class:`~predictionio_tpu_torch.parallel.coded.ShardHealth`, and read
the request deadline from the resilience scope on every call.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..device import matmul_precision
from ..parallel.collectives import ring_shift
from ..parallel.mesh import DATA_AXIS, Mesh, shard_put
from ..resilience import current_deadline
from .topk import _top_k

__all__ = ["ring_topk_scores", "ShardedTopK"]


def _as_shards(table, mesh: Mesh, what: str) -> list:
    """This process's shard tensors of a row-sharded ``table``: a list
    or tuple is taken as the shards themselves, anything else as the
    whole ``[M, ...]`` table to split (its rows a multiple of the mesh
    size)."""
    if isinstance(table, (list, tuple)):
        if len(table) != len(mesh.devices):
            raise ValueError(f"expected {len(mesh.devices)} local {what} "
                             f"shards, got {len(table)}")
        if len({t.shape[0] for t in table}) > 1:
            raise ValueError(f"{what} shards differ in height: "
                             f"{[t.shape[0] for t in table]}")
        return list(table)
    t = table if torch.is_tensor(table) else torch.as_tensor(
        np.asarray(table))
    if t.shape[0] % mesh.size:
        raise ValueError(f"item count {t.shape[0]} must be divisible by "
                         f"mesh size {mesh.size}")
    return shard_put(t, mesh)


def ring_topk_scores(
    queries,
    item_shards,
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    *,
    parity=None,
    row_bias=None,
    health=None,
    deadline=None,
    hop_budget_s: Optional[float] = None,
):
    """Top-k (values, global indices) of ``queries @ item_table.T``.

    ``queries`` is the ``[B, R]`` query block (every process passes the
    same), ``item_shards`` the table: this process's shard tensors
    (``[M/d, R]`` each, in shard order) or the whole ``[M, R]`` table.
    Returns ``([B, k] f32 scores, [B, k] int32 indices)`` on the first
    local shard's device; indices are global rows of the table.

    ``row_bias`` is an additive per-row score bias, sharded like the
    table (shards or the whole ``[M]``): ``-inf`` rows can never win,
    which is how :class:`ShardedTopK` masks its padding rows.

    With ``parity`` set (``parallel.coded.build_parity_fn``'s replicated
    block, one tensor per local shard) and ``d >= 2``, the call is
    straggler-tolerant: before the hops the host polls the
    ``dist.shard_delay`` / ``dist.shard_drop`` / ``dist.worker_kill``
    fault points and the per-shard budget from ``deadline`` (default:
    the :func:`~predictionio_tpu_torch.resilience.current_deadline` in
    scope) or ``hop_budget_s``, and a shard flagged late or dead is
    scored from its parity reconstruction.  ``health`` carries sticky
    state (killed workers) across calls; omitted, an ephemeral tracker
    is built per call."""
    d = mesh.size
    shards = _as_shards(item_shards, mesh, "item")
    M = shards[0].shape[0] * d
    if k > M:
        raise ValueError(f"k={k} > item count {M}")

    ok = None
    if parity is not None and d >= 2:
        from ..parallel.coded import ShardHealth

        if health is None:
            health = ShardHealth(d, hop_budget_s=hop_budget_s,
                                 op="topk.ring")
        if deadline is None:
            deadline = current_deadline()
        mask = health.poll(deadline=deadline)
        if mask.min() < 1.0:
            ok = mask

    if row_bias is None:
        bias = [torch.zeros(s.shape[0], dtype=torch.float32,
                            device=s.device) for s in shards]
    else:
        bias = _as_shards(row_bias, mesh, "bias")

    fn = _ring_callable(mesh, axis, k, ok is not None)
    if ok is not None:
        return fn(queries, shards, bias, parity, ok)
    return fn(queries, shards, bias)


def _ring_callable(mesh: Mesh, axis: str, k: int, coded: bool,
                   candidate_k: int = 0):
    """The ring program per (mesh, axis, k, variant): ``fn(q, shards,
    bias)``, plus ``(parity, ok)`` for the coded variant or ``(q8
    shards, scale shards)`` for the int8 candidate variant
    (``candidate_k > 0``: each hop shortlists ``candidate_k`` local rows
    from the int8 scan and reranks them from the f32 shard).  The two
    do not compose: parity rebuilds f32 rows, which have no quantized
    counterpart, so a degraded call rides the coded exact program."""
    if coded and candidate_k:
        raise ValueError(
            "coded and quantized ring variants do not compose; "
            "degraded calls ride the coded exact program"
        )
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    return functools.partial(_ring, mesh, k, coded, candidate_k)


def _ring(mesh: Mesh, k: int, coded: bool, candidate_k: int, q, shards,
          bias, *extra):
    d = mesh.size
    home = mesh.first_device
    rows = shards[0].shape[0]
    q = torch.atleast_2d(torch.as_tensor(q)).to(home, torch.float32)
    v = list(shards)
    b = [x.to(torch.float32) for x in bias]
    # whose shard each local position holds (a 0-dim tensor that rides
    # the ring with the shard, as the reference's ppermuted owner id)
    owner = [torch.tensor(s, dtype=torch.int64, device=mesh.device_of(s))
             for s in mesh.local]
    recon = ok_t = qv = qs = None
    if coded:
        from ..parallel.collectives import psum

        parity, ok = extra
        okm = [float(ok[s]) for s in mesh.local]
        # the late shard's rows, rebuilt from the survivors: exact while
        # parity is current with the table
        v = [x * m for x, m in zip(v, okm)]
        alive = psum([x.float() for x in v], mesh)[0].to(home)
        recon = (parity[0].to(home) - alive).to(shards[0].dtype)
        ok_t = torch.as_tensor(np.asarray(ok, np.float32), device=home)
    elif candidate_k:
        qv, qs = list(extra[0]), list(extra[1])
    best_val = torch.full((q.shape[0], k), float("-inf"),
                          dtype=torch.float32, device=home)
    best_ix = torch.zeros((q.shape[0], k), dtype=torch.int32, device=home)
    cols = torch.arange(rows, dtype=torch.int64, device=home)
    with matmul_precision("highest"):
        for hop in range(d):
            vh = v[0].to(home)
            bh = b[0].to(home)
            own = owner[0].to(home)
            if recon is not None:
                vh = torch.where(ok_t[own] > 0, vh, recon)
            base = own * rows
            if candidate_k:
                cscores = (q @ qv[0].to(home).T.to(torch.float32)) \
                    * qs[0].to(home)[None, :] + bh[None, :]
                _, cix = _top_k(cscores, candidate_k)           # [B, kc]
                scores = torch.einsum("bkr,br->bk",
                                      vh[cix].to(torch.float32), q) + bh[cix]
                ix = base + cix
            else:
                scores = q @ vh.T.to(torch.float32) + bh[None, :]
                ix = (base + cols).expand(q.shape[0], rows)
            # fold into the running top-k: concatenate and re-top-k
            cat_val = torch.cat([best_val, scores], dim=1)
            cat_ix = torch.cat([best_ix, ix.to(torch.int32)], dim=1)
            best_val, pos = _top_k(cat_val, k)
            best_ix = torch.gather(cat_ix, 1, pos)
            if hop + 1 < d:
                # pass every shard on to the next position, with its
                # bias, its owner id (and its int8 copy)
                v = ring_shift(v, mesh)
                b = ring_shift(b, mesh)
                owner = ring_shift(owner, mesh)
                if candidate_k:
                    qv = ring_shift(qv, mesh)
                    qs = ring_shift(qs, mesh)
    return best_val, best_ix


class ShardedTopK:
    """Serve-time distributed top-k index: sharded item table + parity.

    Built once at model (re)load from the host item-factor table; every
    call answers ``(values, global indices)`` for a query block.  The
    table's rows are padded to a mesh multiple with ``-inf``-biased rows
    (never returned), parity is computed once, and one
    :class:`~predictionio_tpu_torch.parallel.coded.ShardHealth` carries
    straggler state across requests: a worker killed under chaos stays
    killed for this index's lifetime, like a dead host until the next
    reload.

    The per-request deadline needs no plumbing: serving's predict runs
    inside ``deadline_scope(request_deadline)``, and the call reads that
    scope, so the request budget becomes the per-shard hop budget."""

    def __init__(self, item_factors, mesh: Mesh, axis: str = DATA_AXIS,
                 hop_budget_s: Optional[float] = None,
                 retrieval: str = "exact", candidate_factor: int = 10):
        from ..parallel.coded import ShardHealth, build_parity_fn
        from ..parallel.mesh import pad_to_multiple

        if retrieval not in ("exact", "int8", "ivf"):
            raise ValueError(
                f"retrieval must be 'exact', 'int8' or 'ivf', "
                f"got {retrieval!r}"
            )
        self.mesh = mesh
        self.axis = axis
        d = mesh.size
        table = np.asarray(item_factors, np.float32)
        self.n_items = table.shape[0]
        mp = pad_to_multiple(max(self.n_items, d), d)
        padded = np.zeros((mp, table.shape[1]), np.float32)
        padded[: self.n_items] = table
        bias = np.full(mp, -np.inf, np.float32)
        bias[: self.n_items] = 0.0
        self.table = shard_put(padded, mesh)
        self.row_bias = shard_put(bias, mesh)
        self.parity = build_parity_fn(mesh)(self.table)
        self.health = (
            ShardHealth(d, hop_budget_s=hop_budget_s, op="topk.ring")
            if d >= 2 else None
        )
        # the per-shard candidate stage: int8 shards and their per-row
        # scales, sharded like the table and rotated with it.  "ivf"
        # maps to "int8": coarse clusters are a whole-catalog structure
        # and do not shard; the flat int8 scan per hop is the ring's
        # candidate stage
        self.candidate_factor = candidate_factor
        self.retrieval = "int8" if retrieval == "ivf" else retrieval
        if self.retrieval == "int8":
            from .ann import quantize_rows

            q8, scale = quantize_rows(padded)
            self.q_table = shard_put(q8, mesh)
            self.q_scale = shard_put(scale, mesh)
        else:
            self.q_table = self.q_scale = None

    @property
    def shard_rows(self) -> int:
        return self.table[0].shape[0]

    def _candidate_k(self, k: int) -> int:
        """Per-hop shortlist width: ``candidate_factor * k``, at least
        ``k``, capped at the shard height (a shortlist covering the
        whole shard is the exact scan)."""
        return min(max(self.candidate_factor * k, k), self.shard_rows)

    def _queries(self, queries) -> torch.Tensor:
        q = queries if torch.is_tensor(queries) else torch.as_tensor(
            np.asarray(queries, np.float32))
        return torch.atleast_2d(q).to(self.mesh.first_device,
                                      torch.float32)

    def __call__(self, queries, k: int, deadline=None):
        q = self._queries(queries)
        k = min(k, self.n_items)
        if self.q_table is not None:
            ok = None
            if self.health is not None:
                ok = self.health.poll(
                    deadline=deadline or current_deadline()
                )
            if ok is None or ok.min() >= 1.0:
                fn = _ring_callable(self.mesh, self.axis, k, False,
                                    self._candidate_k(k))
                return fn(q, self.table, self.row_bias, self.q_table,
                          self.q_scale)
            # degraded: parity reconstruction has no quantized
            # counterpart, so the call rides the coded exact ring
            fn = _ring_callable(self.mesh, self.axis, k, True)
            return fn(q, self.table, self.row_bias, self.parity, ok)
        return ring_topk_scores(
            q, self.table, k, self.mesh, self.axis,
            parity=self.parity if self.health is not None else None,
            row_bias=self.row_bias,
            health=self.health,
            deadline=deadline,
        )

    def warm(self, k: int, batch: int = 1) -> None:
        """Run every ring variant this index can take (clean, coded,
        and the int8 candidate one under ``retrieval != "exact"``) once
        at this ``(batch, k)`` shape, bypassing the health poll: on the
        card there is nothing to compile, but the first degraded request
        must not pay the allocator's and the first launches' set-up on
        top of the straggler it absorbs."""
        k = min(k, self.n_items)
        q = torch.zeros((batch, self.table[0].shape[1]), dtype=torch.float32,
                        device=self.mesh.first_device)
        _ring_callable(self.mesh, self.axis, k, False)(
            q, self.table, self.row_bias)
        if self.q_table is not None:
            _ring_callable(self.mesh, self.axis, k, False,
                           self._candidate_k(k))(
                q, self.table, self.row_bias, self.q_table, self.q_scale)
        if self.health is not None:
            _ring_callable(self.mesh, self.axis, k, True)(
                q, self.table, self.row_bias, self.parity,
                np.ones(self.mesh.size, np.float32))

    def summary(self) -> dict:
        """Status-JSON block (``distributedTopk`` in serving status)."""
        out = {
            "items": self.n_items,
            "shards": int(self.mesh.size),
            "retrieval": self.retrieval,
        }
        if self.retrieval == "int8":
            out["candidateFactor"] = self.candidate_factor
        if self.health is not None:
            out.update(self.health.summary())
        return out
