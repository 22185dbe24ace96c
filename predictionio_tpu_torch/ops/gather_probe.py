"""Gather probes: the three gather kernels behind ``fused_gather="auto"``.

Port of ``predictionio_tpu/ops/gather_probe.py``.  The TPU package timed
the gather forms Mosaic can lower, in isolation, so that the fused ALS
kernel could choose its in-kernel gather (:func:`preferred_order`).  On
Hopper the question is the same, with the forms the fused kernel
(``csrc/fused_als.cu``) has: rows loaded element by element through L2
(``"taa"``) or copied row by row into shared memory with ``cp.async``
(``"dma"``).  ``csrc/gather_probe.cu`` holds the three probe kernels:

  A. :func:`taa0_gather` — same-shape ``take_along_axis(axis=0)``:
     ``out[i, j] = table[idx[i, j], j]``, one thread per element; the
     access pattern of the fused kernel's ``"taa"`` form.
  B. :func:`taa1_gather` — the transposed form on ``[R, M]``:
     ``out[i, j] = table[i, idx[i, j]]``, a row from the grid's second
     axis; 16 columns a thread as 16-byte vectors on a long row of whole
     aligned vectors, one column a thread on every other row; measured
     for completeness.
  C. :func:`dma_row_gather` — ``out[k] = table[idx[k]]`` through a ring
     of 16 row slots (the reference's ``_DMA_WINDOW``) filled by
     ``cp.async``; the fused kernel's ``"dma"`` form.
  D. :func:`xla_take` — the library row take (``torch.index_select``) on
     the same shapes, the yardstick every kernel is held to; the grouped
     slab takes of :func:`probe_xla_grouped_take` are plain torch too.

On a CPU tensor each kernel wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises.  A probe checks a kernel's
output against the plain version with ``torch.equal`` (a gather is a
copy: the tolerance is zero) and, unlike the reference, lets a launch
error raise: on the card a failing probe is a fault of the port, not
data about a compiler.  A probe runs on the card unless it is given
``device="cpu"``, and raises without one.  :func:`preferred_order`
measures only on the card, and there times the card's work, not the
host's (:func:`_bench`); a CPU run gets the static order.

The wrappers are held to the host cost of the PyTorch call each stands
beside: one branch on the table's device (``is_cuda``, which builds no
``torch.device``), one pass of checks over the two tensors
(:func:`_gather_checks`), one allocation, and the row-copy plan from a
cache.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ._build import launch
from .fused_als import SMS, sm_count

__all__ = [
    "PROBE_NS",
    "RowPlan",
    "dma_row_gather",
    "dma_row_gather_reference",
    "dma_row_plan",
    "preferred_order",
    "probe_dma",
    "probe_taa0",
    "probe_taa1",
    "probe_xla_grouped_take",
    "probe_xla_take",
    "smoke",
    "taa0_gather",
    "taa0_gather_reference",
    "taa1_gather",
    "taa1_gather_reference",
    "xla_take",
]

_DMA_WINDOW = 16
# csrc/gather_probe.cu kMaxRowsPerGroup: the longest run of rows one
# copying group walks
_MAX_ROWS_PER_GROUP = 2 * _DMA_WINDOW

# csrc/gather_probe.cu dma_row_kernel: blocks of 128 threads
_ROW_THREADS = 128
# shared memory one block may hold on an H100 (after the opt-in)
_SMEM_MAX = 232_448

# device cycles the card spins before a timed run (about 2 ms on an
# H100), so that the run's launches are all queued before it starts
_SPIN_CYCLES = 1 << 22

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _probe_device(device) -> torch.device:
    """The device a probe runs on: ``device``, the card when it is None
    (:func:`~predictionio_tpu_torch.device.resolve_device`: raises
    without one)."""
    return resolve_device("cuda" if device is None else device)


def _bench(fn, *args, reps: int = 50):
    """Mean seconds of ``fn(*args)`` over ``reps`` calls after one
    warm-up call, and the last output.  On the host the clock times the
    calls.  On the card CUDA events time the card's work alone: the
    stream first spins (``torch.cuda._sleep``) while the host queues all
    ``reps`` calls, so the events see the kernels back to back and not
    the host's launch path.  When the spin ran out before the last call
    was queued, the run is taken again behind a spin four times longer
    (up to 64 times the first)."""
    out = fn(*args)
    if out.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return (time.perf_counter() - t0) / reps, out
    with torch.cuda.device(out.device):
        torch.cuda.synchronize()
        cycles = _SPIN_CYCLES
        while True:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            t0.record()
            for _ in range(reps):
                out = fn(*args)
            t1.record()
            queued_ahead = not t0.query()
            t1.synchronize()
            if queued_ahead or cycles >= _SPIN_CYCLES << 6:
                return t0.elapsed_time(t1) / 1e3 / reps, out
            cycles <<= 2


def _gather_checks(table: torch.Tensor, idx: torch.Tensor,
                   idx_shape) -> int:
    """Raise unless ``table`` is a contiguous f32 or bf16 tensor and
    ``idx`` a contiguous int32 tensor of ``idx_shape`` on the same
    device: the kernels are handed bare pointers and trust all of it.
    Returns the table's element bytes."""
    eb = _ELEM_BYTES.get(table.dtype)
    if eb is None:
        raise TypeError(
            f"table must be float32 or bfloat16, got {table.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be torch.int32, got {idx.dtype}")
    if idx.shape != idx_shape:
        raise ValueError(
            f"idx has shape {tuple(idx.shape)}, expected {tuple(idx_shape)}"
        )
    if idx.get_device() != table.get_device():
        raise ValueError(f"idx is on {idx.device}, expected {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    return eb


# ---------------------------------------------------------------- A --

def taa0_gather_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`taa0_gather` (advanced indexing)."""
    cols = torch.arange(table.shape[1], device=table.device)
    return table[idx.long(), cols[None, :]]


def taa0_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = table[idx[i, j], j]`` for ``table [N, R]`` and
    ``idx [N, R]`` int32 (row ids broadcast across the columns) ->
    ``[N, R]``.  An id outside the table gives NaN on the card; the plain
    version raises."""
    if not table.is_cuda:
        if table.is_cpu:
            return taa0_gather_reference(table, idx)
        raise ValueError(f"unsupported device {table.device}")
    n, r = table.shape
    eb = _gather_checks(table, idx, (n, r))
    out = torch.empty_like(table)
    launch("pio_taa0_gather", "taa0_gather", table.device,
           table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, r, eb)
    return out


def _table_rows(n, r, dtype, device, rng) -> torch.Tensor:
    return torch.from_numpy(
        rng.normal(size=(n, r)).astype(np.float32)
    ).to(device=device, dtype=dtype)


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def probe_taa0(n, r, dtype, device=None) -> dict:
    dev = _probe_device(device)
    rng = np.random.default_rng(0)
    table = _table_rows(n, r, dtype, dev, rng)
    rows = rng.integers(0, n, size=(n,)).astype(np.int32)
    idx = torch.from_numpy(
        np.broadcast_to(rows[:, None], (n, r)).copy()
    ).to(dev)
    dt, out = _bench(taa0_gather, table, idx)
    good = bool(torch.equal(out, taa0_gather_reference(table, idx)))
    return dict(metric="taa_axis0", n=n, r=r, dtype=_dtype_name(dtype),
                device=dev.type, ok=good, seconds=dt,
                ns_per_row=dt / n * 1e9)


# ---------------------------------------------------------------- B --

def taa1_gather_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`taa1_gather` (advanced indexing)."""
    rows = torch.arange(table.shape[0], device=table.device)
    return table[rows[:, None], idx.long()]


def taa1_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = table[i, idx[i, j]]`` for ``table [R, M]`` and
    ``idx [R, M]`` int32 -> ``[R, M]`` (form B).  An id outside the row
    gives NaN on the card; the plain version raises."""
    if not table.is_cuda:
        if table.is_cpu:
            return taa1_gather_reference(table, idx)
        raise ValueError(f"unsupported device {table.device}")
    r, m = table.shape
    eb = _gather_checks(table, idx, (r, m))
    out = torch.empty_like(table)
    launch("pio_taa1_gather", "taa1_gather", table.device,
           table.data_ptr(), idx.data_ptr(), out.data_ptr(), r, m, eb)
    return out


def probe_taa1(m, r, dtype, device=None) -> dict:
    dev = _probe_device(device)
    rng = np.random.default_rng(0)
    table = _table_rows(r, m, dtype, dev, rng)
    cols = rng.integers(0, m, size=(m,)).astype(np.int32)
    idx = torch.from_numpy(
        np.broadcast_to(cols[None, :], (r, m)).copy()
    ).to(dev)
    dt, out = _bench(taa1_gather, table, idx)
    good = bool(torch.equal(out, taa1_gather_reference(table, idx)))
    return dict(metric="taa_axis1", m=m, r=r, dtype=_dtype_name(dtype),
                device=dev.type, ok=good, seconds=dt,
                ns_per_col=dt / m * 1e9)


# ---------------------------------------------------------------- C --

class RowPlan(NamedTuple):
    """Launch plan of the row-copy kernel: ``vec`` bytes per ``cp.async``
    piece, the rows each copying group walks, the grid, and one block's
    shared memory (each group's ring of row slots and the block's ids)."""

    vec: int
    rows_per_group: int
    blocks: int
    smem_bytes: int


def _row_smem_bytes(groups: int, row_bytes: int, rows_per_group: int) -> int:
    """csrc/gather_probe.cu ``row_smem_bytes``: each group's ring of
    ``min(rows_per_group, 16)`` row slots, then the block's int32 ids."""
    slots = min(rows_per_group, _DMA_WINDOW)
    return groups * (slots * row_bytes + rows_per_group * 4)


@functools.lru_cache(maxsize=1024)
def dma_row_plan(r: int, elem_bytes: int, nout: int, aligned16: bool = True,
                 sms: int = SMS) -> Optional[RowPlan]:
    """Plan of ``csrc/gather_probe.cu`` ``dma_row_kernel`` for ``nout``
    rows of ``r`` elements of ``elem_bytes`` on a card of ``sms`` SMs
    (cached: the wrapper asks on every call).

    Rows are copied in 16-byte pieces where a row is a whole number of
    them and the table starts 16-byte aligned, else in 4-byte pieces.
    Each block of 128 threads splits into groups as wide as a row's
    pieces.  A group walks ``nout // (groups * sms)`` rows, at least 1
    and at most 32, so that a launch of ``nout >= groups * sms`` rows
    covers every SM at least once, with at most 16 rows in flight.  None
    when a row is not a whole number of 4-byte pieces (a bf16 row of odd
    ``r``) or a ring of 16 slots and 32 ids per group does not fit a
    block's shared memory, whatever ``nout``."""
    row_bytes = r * elem_bytes
    if r < 1 or row_bytes % 4:
        return None
    vec = 16 if row_bytes % 16 == 0 and aligned16 else 4
    pieces = row_bytes // vec
    lanes = min(pieces, _ROW_THREADS)
    groups = _ROW_THREADS // lanes
    if _row_smem_bytes(groups, row_bytes, _MAX_ROWS_PER_GROUP) > _SMEM_MAX:
        return None
    rpg = max(1, min(_MAX_ROWS_PER_GROUP, nout // (groups * sms)))
    return RowPlan(vec=vec, rows_per_group=rpg,
                   blocks=-(-nout // (groups * rpg)),
                   smem_bytes=_row_smem_bytes(groups, row_bytes, rpg))


def dma_row_gather_reference(table: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dma_row_gather`."""
    return table[idx.long()]


def dma_row_gather(table: torch.Tensor, idx: torch.Tensor, *,
                   nout: int) -> torch.Tensor:
    """Rolling-window async row-copy gather (form C): ``table [M, R]``,
    ``idx [nout]`` int32 -> ``out [nout, R]``, one ``cp.async`` row copy
    per output row with 16 rows in flight per copying group.  Raises
    ``ValueError`` for a table with no plan (a bf16 table of odd R);
    an id outside the table gives NaN on the card."""
    shape = (nout,)
    if idx.shape != shape:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                         f"({nout},)")
    m, r = table.shape
    if not table.is_cuda:
        if table.is_cpu:
            return dma_row_gather_reference(table, idx)
        raise ValueError(f"unsupported device {table.device}")
    eb = _gather_checks(table, idx, shape)
    dev = table.device
    ptr = table.data_ptr()
    plan = dma_row_plan(r, eb, nout, ptr % 16 == 0, sm_count(dev.index))
    if plan is None or ptr % 4:
        raise ValueError(
            f"dma_row_gather: no plan for rows of {r} x {eb} bytes "
            "(a row must be a whole number of 4-byte pieces)"
        )
    out = table.new_empty((nout, r))
    launch("pio_dma_row_gather", "dma_row_gather", dev,
           ptr, idx.data_ptr(), out.data_ptr(), m, nout, r, eb,
           plan.vec, plan.rows_per_group, plan.blocks, plan.smem_bytes)
    return out


def probe_dma(m, nout, r, dtype, device=None) -> dict:
    """Time and check :func:`dma_row_gather`; a shape with no plan is a
    record with ``ok=False``, a launch error raises."""
    dev = _probe_device(device)
    rec = dict(metric="dma_row_gather", m=m, nout=nout, r=r,
               dtype=_dtype_name(dtype), device=dev.type)
    elem = torch.empty((), dtype=dtype).element_size()
    if dma_row_plan(r, elem, nout) is None:
        return dict(rec, ok=False,
                    error=f"no row-copy plan for r={r} at {elem} bytes")
    rng = np.random.default_rng(0)
    table = _table_rows(m, r, dtype, dev, rng)
    rows = rng.integers(0, m, size=(nout,)).astype(np.int32)
    idx = torch.from_numpy(rows).to(dev)
    dt, out = _bench(lambda t, i: dma_row_gather(t, i, nout=nout), table, idx)
    good = bool(torch.equal(out, dma_row_gather_reference(table, idx)))
    return dict(rec, ok=good, seconds=dt, ns_per_row=dt / nout * 1e9)


# ---------------------------------------------------------------- E --

def probe_xla_grouped_take(m, nout, r, dtype, group=None,
                           device=None) -> list[dict]:
    """The reference's grouped slab takes, both layouts, as plain torch
    beside the plain row take: ``xla_grouped_take`` gathers ``[G*R]``
    slabs of the ``[M/G, G*R]`` view, ``xla_grouped3d_take`` ``[G, R]``
    slices of ``[M/G, G, R]``, and each picks its row out of the slab.
    ``group`` defaults to the reference's 8 rows (f32) or 16 (bf16)."""
    dev = _probe_device(device)
    elem = torch.empty((), dtype=dtype).element_size()
    if group is None:
        group = 8 * (4 // elem)
    mg = -(-m // group) * group
    rng = np.random.default_rng(0)
    table = _table_rows(mg, r, dtype, dev, rng)
    idx = torch.from_numpy(
        rng.integers(0, m, size=(nout,)).astype(np.int64)
    ).to(dev)

    def grouped_lanes(t, i):
        g = torch.index_select(t.reshape(mg // group, group * r), 0,
                               i // group)
        return g.reshape(nout, group, r)[torch.arange(nout, device=dev),
                                         i % group]

    def grouped_tiles(t, i):
        g = torch.index_select(t.reshape(mg // group, group, r), 0,
                               i // group)
        return g[torch.arange(nout, device=dev), i % group]

    want = torch.index_select(table, 0, idx)
    bytes_useful = nout * r * elem
    out = []
    for name, fn in (("xla_grouped_take", grouped_lanes),
                     ("xla_grouped3d_take", grouped_tiles)):
        dt, got = _bench(fn, table, idx)
        out.append(dict(metric=name, m=m, nout=nout, r=r, group=group,
                        dtype=_dtype_name(dtype), device=dev.type,
                        ok=bool(torch.equal(got, want)), seconds=dt,
                        ns_per_row=dt / nout * 1e9,
                        useful_gbps=bytes_useful / dt / 1e9))
    return out


# ---------------------------------------------------------------- D --

def xla_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The library row take on identical shapes (form D): the yardstick,
    never a stand-in for a kernel."""
    return torch.index_select(table, 0, idx)


def probe_xla_take(m, nout, r, dtype, device=None) -> dict:
    dev = _probe_device(device)
    rng = np.random.default_rng(0)
    table = _table_rows(m, r, dtype, dev, rng)
    idx = torch.from_numpy(
        rng.integers(0, m, size=(nout,)).astype(np.int32)
    ).to(dev)
    dt, _ = _bench(xla_take, table, idx)
    bytes_moved = nout * r * table.element_size()
    return dict(metric="xla_take", m=m, nout=nout, r=r,
                dtype=_dtype_name(dtype), device=dev.type, seconds=dt,
                ns_per_row=dt / nout * 1e9,
                effective_gbps=bytes_moved / dt / 1e9)


# -- arbitration ------------------------------------------------------------

# fused-kernel gather forms in the reference's documentation order
_STATIC_ORDER = ("taa", "dma")

# (device name, r, table_bytes) -> measured preference order
_ORDER_CACHE: dict[tuple, tuple] = {}
# the same key -> each form's measured ns per row behind that order
PROBE_NS: dict[tuple, dict] = {}
# one measurement at a time: trainers built in several threads (a
# parallel evaluation sweep) wait for the first one's order instead of
# timing the probes against each other's kernels
_ORDER_LOCK = threading.Lock()


def preferred_order(r: int = 64, table_bytes: int = 4,
                    device=None) -> tuple:
    """Gather-form preference order for ``fused_gather="auto"``.

    On the host (``device="cpu"``) this is the static documentation
    order: deterministic, which the CPU tests depend on.  On the card
    (``device`` None or CUDA; None without a card raises) it runs the
    form-A and form-C probes at n = 2048 once per (device name, rank,
    table width), ranks the forms by the card's nanoseconds per row
    (:func:`_bench` keeps the host's launch path out of them), caches
    the order and keeps the numbers in :data:`PROBE_NS`.  A form with no
    plan at that rank and width sorts last.  Callers in several threads
    get the one order the first of them measured."""
    dev = _probe_device(device)
    if dev.type != "cuda":
        return _STATIC_ORDER
    key = (torch.cuda.get_device_name(dev), int(r), int(table_bytes))
    with _ORDER_LOCK:
        cached = _ORDER_CACHE.get(key)
        if cached is None:
            cached = _ORDER_CACHE[key] = _measure_order(
                key, r, table_bytes, dev)
    return cached


def _measure_order(key: tuple, r: int, table_bytes: int, dev) -> tuple:
    """Run the two probes and rank the forms (:func:`preferred_order`);
    keeps the numbers in :data:`PROBE_NS`."""
    dtype = torch.bfloat16 if table_bytes == 2 else torch.float32
    n = 2048
    results = {
        "taa": probe_taa0(n, r, dtype, device=dev),
        "dma": probe_dma(n, n, r, dtype, device=dev),
    }
    for impl, rec in results.items():
        if "error" not in rec and not rec["ok"]:
            raise AssertionError(
                f"gather probe {rec['metric']} disagrees with its plain "
                f"version at r={r}, {rec['dtype']}"
            )

    def rank_key(impl):
        rec = results[impl]
        return (not rec["ok"], rec.get("ns_per_row", float("inf")))

    PROBE_NS[key] = {impl: rec.get("ns_per_row")
                     for impl, rec in results.items()}
    return tuple(sorted(_STATIC_ORDER, key=rank_key))


def smoke(r: int = 16, device=None) -> list[dict]:
    """Small-shape run of every probe form (the reference's
    ``tools/probe_gather.py --smoke`` records).  Returns the records; a
    form without a plan carries ``ok=False``, a launch error raises."""
    recs = [
        probe_xla_take(512, 256, r, torch.float32, device=device),
        probe_taa0(256, r, torch.float32, device=device),
        probe_taa0(256, r, torch.bfloat16, device=device),
        probe_taa1(256, r, torch.float32, device=device),
        probe_dma(512, 256, r, torch.float32, device=device),
    ]
    recs.extend(probe_xla_grouped_take(512, 256, r, torch.float32,
                                       device=device))
    return recs
