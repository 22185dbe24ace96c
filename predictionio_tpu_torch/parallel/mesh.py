"""The mesh of shards: an ordered list of shard devices, one data axis.

Port of ``predictionio_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over its visible devices and runs its sharded
programs under ``shard_map``; here a :class:`Mesh` is the ordered list
of ``d`` shard devices, and shard ``s`` of a row-sharded table
(the reference's ``P('data', None)``) is the ``s``-th contiguous row
block, held on ``devices[s]``.  The list may repeat a device: four
shards on ``cuda:0`` run the sharded programs of a four-device mesh on
one card, one shard after another, as the reference's tests run eight
virtual CPU devices in one process.

A mesh may span processes (:func:`distributed_init` first): each process
holds a contiguous range of the shards, and the collectives of
``parallel/collectives.py`` go through the ``torch.distributed`` process
group.  The backend follows one rule, recorded on the mesh: NCCL where
every process has a card of its own, gloo on the CPU and where
processes share a card (NCCL refuses two ranks on one device).

There is no fallback: :func:`make_mesh` over no visible card raises, it
never moves to the host unless the caller lists host devices.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike

logger = logging.getLogger(__name__)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "distributed_init",
    "distributed_shutdown",
    "fence",
    "make_mesh",
    "pad_to_multiple",
    "process_count",
    "process_index",
    "shard_put",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the process group this process joined through distributed_init, and
# the backend the rule chose for it
_GROUP: dict = {"backend": None, "rank": 0, "world": 1}


def process_index() -> int:
    """This process's rank in the run (0 without a process group)."""
    return _GROUP["rank"]


def process_count() -> int:
    """The number of processes in the run (1 without a process group)."""
    return _GROUP["world"]


def _card_ids(device: torch.device) -> list[str]:
    """The UUIDs of the cards this process would place shards on."""
    if device.type != "cuda":
        return []
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to join the "
            "run with host shards"
        )
    idx = [device.index] if device.index is not None else \
        range(torch.cuda.device_count())
    return [str(torch.cuda.get_device_properties(i).uuid) for i in idx]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
    timeout_s: float = 300.0,
) -> Optional[str]:
    """Join a multi-process run; a no-op (returns None) when the
    arguments are absent, as the reference's.

    ``coordinator_address`` is ``host:port``; process 0 serves a TCP
    store there, and every process publishes the UUIDs of the cards it
    would use (``device``: ``"cuda"`` for every visible card, ``"cpu"``
    for host shards).  The backend is chosen from them: ``"nccl"`` when
    every process has cards of its own, ``"gloo"`` on the CPU or when
    two processes name one card.  Returns the backend."""
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError(
            "distributed_init needs the coordinator address, the number "
            "of processes and this process's id"
        )
    import datetime

    import torch.distributed as dist

    host, _, port = str(coordinator_address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address must be host:port, got "
            f"{coordinator_address!r}"
        )
    n, rank = int(num_processes), int(process_id)
    if not 0 <= rank < n:
        raise ValueError(f"process id {rank} out of range 0..{n - 1}")
    dev = torch.device(device)
    store = dist.TCPStore(
        host, int(port), world_size=n, is_master=rank == 0,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    cards = _card_ids(dev)
    store.set(f"pio/cards/{rank}", ",".join(cards))
    seen: list[str] = []
    for r in range(n):
        got = store.get(f"pio/cards/{r}").decode()
        seen.extend(c for c in got.split(",") if c)
    shared = len(seen) != len(set(seen))
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _GROUP.update(backend=backend, rank=rank, world=n)
    logger.info("process %d of %d joined the run over %s (cards %s)",
                rank, n, backend, cards or "none")
    return backend


def distributed_shutdown() -> None:
    """Leave the process group :func:`distributed_init` joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.update(backend=None, rank=0, world=1)


@dataclass
class Mesh:
    """A one-axis mesh of ``size`` shards; this process holds shards
    ``lo`` to ``hi - 1``, on ``devices`` (one device per local shard,
    in shard order; entries may repeat).  ``backend`` is the process
    group's backend, None when every shard is in this process."""

    devices: tuple
    size: int
    lo: int = 0
    backend: Optional[str] = None
    axis_names: tuple = (DATA_AXIS,)
    # the process that holds each shard, in shard order
    owner: tuple = field(default=())

    @property
    def hi(self) -> int:
        return self.lo + len(self.devices)

    @property
    def local(self) -> range:
        """The shard ids this process holds."""
        return range(self.lo, self.hi)

    @property
    def multiprocess(self) -> bool:
        return self.backend is not None

    @property
    def first_device(self) -> torch.device:
        return self.devices[0]

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard - self.lo]

    def __repr__(self) -> str:
        where = ", ".join(str(d) for d in self.devices)
        return (f"Mesh(size={self.size}, shards {self.lo}..{self.hi - 1} "
                f"on [{where}], backend={self.backend})")


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu', ...] to "
            "build a mesh of host shards"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible card of this
    process).  ``n_devices`` is the total shard count and must equal
    the devices of every process together; in a multi-process run each
    process lists its own shards and holds a contiguous range of them,
    in rank order.  Raises, as the reference does, when the devices do
    not give the shape asked for; never falls back to the host."""
    local = ([torch.device(d) for d in devices] if devices is not None
             else _visible_cards())
    for d in local:
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"name the card of every CUDA shard, got {d}")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"shard devices must be cuda or cpu, got {d}")
    backend = _GROUP["backend"]
    if backend is None:
        if n_devices is not None:
            if n_devices > len(local):
                raise ValueError(
                    f"mesh shape [{n_devices}] != device count {len(local)}"
                )
            local = local[:n_devices]
        if not local:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devices=tuple(local), size=len(local),
                    owner=(0,) * len(local))
    import torch.distributed as dist

    counts: list = [None] * _GROUP["world"]
    dist.all_gather_object(counts, len(local))
    total = int(sum(counts))
    if n_devices is not None and n_devices != total:
        raise ValueError(f"mesh shape [{n_devices}] != device count {total}")
    rank = _GROUP["rank"]
    owner = tuple(p for p, c in enumerate(counts) for _ in range(c))
    return Mesh(devices=tuple(local), size=total,
                lo=int(sum(counts[:rank])), backend=backend, owner=owner)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n`` (static-shape padding budgets)."""
    return ((n + m - 1) // m) * m


def shard_put(arr, mesh: Mesh) -> list:
    """This process's row blocks of ``arr`` (``[N, ...]``, ``N`` a
    multiple of the mesh size), each on its shard's device: the
    reference's ``shard_put`` with ``P('data', ...)``."""
    t = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr)
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"{n} rows do not split into {mesh.size} equal shards; pad to "
            "a multiple of the mesh size first"
        )
    blk = n // mesh.size
    return [t[s * blk:(s + 1) * blk].to(mesh.device_of(s)).clone()
            for s in mesh.local]


def fence(mesh_or_devices) -> None:
    """Wait until every card of the mesh has finished its queued work
    (``torch.cuda.synchronize`` of each, once); nothing on the CPU."""
    devs = (mesh_or_devices.devices if isinstance(mesh_or_devices, Mesh)
            else mesh_or_devices)
    for d in dict.fromkeys(torch.device(x) for x in devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
