"""Mesh collectives over per-shard tensors.

Port of ``predictionio_tpu/parallel/collectives.py``.  The reference
runs each primitive as a ``shard_map`` program over a global sharded
array; here a sharded value is the list of this process's shard
tensors (one per local shard of the :class:`~.mesh.Mesh`, in shard
order), and a replicated value is the list of one tensor per local
shard (the same tensor where shards share a device).  In one process a
collective is a concatenation or a sum; across processes it goes
through the ``torch.distributed`` process group, on the shards' own
tensors whatever the backend: gloo takes CUDA tensors for the two
collectives used here (``all_reduce`` and ``all_gather``; the two-process
console train of ``chip_smoke.py`` phase dist runs them over gloo on one
H100 with torch 2.11), so no collective goes through the host.
"""

from __future__ import annotations

import torch

from .mesh import Mesh

__all__ = [
    "all_gather_blocks",
    "all_reduce_sum",
    "all_to_all_blocks",
    "allreduce_host",
    "gather_shards",
    "psum",
    "reduce_scatter_sum",
    "ring_shift",
]

def _dist_all_reduce(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    # a copy: the collective works in place, and t may alias a shard
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t)
    return t


def _dist_all_gather(t: torch.Tensor) -> list:
    """Every process's ``t`` (equal shapes), in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def _replicate(value: torch.Tensor, mesh: Mesh) -> list:
    """One copy of ``value`` per local shard (shared per device)."""
    return [value.to(d) for d in mesh.devices]


def _check_parts(parts, mesh: Mesh) -> None:
    if len(parts) != len(mesh.devices):
        raise ValueError(
            f"expected {len(mesh.devices)} local shard tensors, got "
            f"{len(parts)}"
        )


def allreduce_host(arr, mesh: Mesh):
    """Sum a host array over the processes of ``mesh`` (numpy in, numpy
    out; once per process, not per shard)."""
    import numpy as np

    if not mesh.multiprocess:
        return np.asarray(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.first_device)
    return _dist_all_reduce(t).cpu().numpy()


def psum(parts, mesh: Mesh) -> list:
    """Elementwise sum of every shard's tensor, replicated (the
    reference's ``jax.lax.psum`` inside a ``shard_map``)."""
    _check_parts(parts, mesh)
    home = mesh.first_device
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    if mesh.multiprocess:
        total = _dist_all_reduce(total)
    return _replicate(total, mesh)


def gather_shards(parts, mesh: Mesh) -> list:
    """Every shard's tensor (equal shapes), in shard order, on this
    process's first shard device."""
    _check_parts(parts, mesh)
    home = mesh.first_device
    local = [p.to(home) for p in parts]
    if not mesh.multiprocess:
        return local
    got = _dist_all_gather(torch.stack(local))
    return [blk for g in got for blk in g.unbind(0)]


def all_reduce_sum(parts, mesh: Mesh) -> list:
    """Sum a row-sharded array over its rows: ``[N, ...]`` sharded ->
    the ``[...]`` total, replicated."""
    return psum([p.sum(0) for p in parts], mesh)


def all_gather_blocks(parts, mesh: Mesh) -> list:
    """Gather a sharded leading dim onto every shard: ``[N/d]`` per
    shard -> ``[N]`` replicated (the factor-block exchange)."""
    return _replicate(torch.cat(gather_shards(parts, mesh)), mesh)


def all_to_all_blocks(parts, mesh: Mesh) -> list:
    """Shard transpose: shard ``i``'s ``j``-th block becomes shard
    ``j``'s ``i``-th block.  Each shard holds ``d`` equal blocks, so the
    global leading dim must be a multiple of ``d * d``."""
    d = mesh.size
    n = parts[0].shape[0] * d
    if n % (d * d) != 0:
        raise ValueError(
            f"all_to_all_blocks needs leading dim divisible by "
            f"mesh_size^2 = {d * d} (d equal blocks per device shard); "
            f"got shape {(n, *parts[0].shape[1:])}"
        )
    shards = gather_shards(parts, mesh)
    blk = parts[0].shape[0] // d
    return [
        torch.cat([shards[i][j * blk:(j + 1) * blk] for i in range(d)])
        .to(mesh.device_of(j))
        for j in mesh.local
    ]


def reduce_scatter_sum(parts, mesh: Mesh) -> list:
    """Per-shard partials ``[1, M, ...]`` (one per shard) -> their sum
    ``[M, ...]`` sharded over the mesh: each shard keeps its slice."""
    d = mesh.size
    lead = parts[0].shape[0] * d
    if any(p.shape[0] != 1 for p in parts):
        raise ValueError(
            f"reduce_scatter_sum expects leading dim == mesh axis size "
            f"{d} (one partial per device); got shape "
            f"{(lead, *parts[0].shape[1:])}"
        )
    total = psum([p[0] for p in parts], mesh)
    blk = total[0].shape[0] // d
    return [total[k][s * blk:(s + 1) * blk]
            for k, s in enumerate(mesh.local)]


def ring_shift(parts, mesh: Mesh, shift: int = 1) -> list:
    """Rotate shards around the ring: shard ``i`` -> position
    ``(i + shift) mod d``."""
    d = mesh.size
    shards = gather_shards(parts, mesh)
    return [shards[(j - shift) % d].to(mesh.device_of(j))
            for j in mesh.local]
