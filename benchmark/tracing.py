"""What a ``torch.profiler`` trace of whole trains says about the device.

The traced stretch runs inside a ``bench.stretch`` range, each train
inside ``bench.train`` and each half-iteration inside ``bench.half``
(the harness fences the device at both ends of a half, so every device
operation of a half lies inside its range).  From the profiler's events
this module takes:

* ``window_s`` — the length of the stretch;
* ``busy_s`` — the time in which some device operation (kernel, copy or
  fill) ran, as the union of their intervals inside the stretch;
* ``half_device_s`` — the same union inside the halves;
* ``device_ops`` — device seconds by operation name, the ten largest;
* ``idle_gaps`` — the device's idle time inside the stretch, by what the
  host was doing at the middle of each gap (the innermost host event
  there, under the innermost ``bench.*`` range), the ten largest.

Imports only torch.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import torch

__all__ = ["TraceSummary", "summarize"]

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# how far back from a gap to look for the host event around it
_LOOKBACK = 64


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    half_device_s: float
    device_ops: list
    idle_gaps: list
    device_events: int


def _kind(ev, on_device: bool) -> str:
    """The profiler's activity type of an event (``kernel``,
    ``gpu_memcpy``, ``user_annotation`` ...); a build of torch whose
    events do not carry it still tells its annotations apart."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    if ev.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device else "cpu_op"


def _union(intervals: list) -> list:
    """Merge ``(start, end)`` pairs into disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged: list, lo: int, hi: int) -> int:
    """Length of ``[lo, hi]`` covered by the merged intervals."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def short_name(name: str, most: int = 120) -> str:
    """A device operation's name without its parameter list (the last
    balanced parenthesis) and ``void``, at most ``most`` characters."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k] if k else name
                break
    name = name.removeprefix("void ").strip()
    return name[:most]


def _top(totals: dict, n: int = 10) -> list:
    return [[name, ns / 1e9] for name, ns in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events) -> TraceSummary:
    """Summarise the profiler's events (``prof.profiler.kineto_results
    .events()``) of one traced stretch."""
    stretch, halves, ranges, device, host = None, [], [], [], []
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        kind = _kind(ev, on_device)
        if on_device:
            if kind in DEVICE_KINDS:
                device.append((start, end, short_name(ev.name())))
            continue
        name = ev.name()
        if kind == "user_annotation" and name.startswith("bench."):
            if name == "bench.stretch":
                stretch = (start, end)
            elif name == "bench.half":
                halves.append((start, end))
            ranges.append((start, end, name))
        else:
            host.append((start, end, name))
    if stretch is None:
        raise ValueError("the trace holds no bench.stretch range")
    lo, hi = stretch
    device = [(max(s, lo), min(e, hi), n) for s, e, n in device
              if e > lo and s < hi]
    busy = _union([(s, e) for s, e, _ in device])
    by_name: dict = {}
    for s, e, n in device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    half_ns = sum(_covered(busy, s, e) for s, e in halves)

    host.sort()
    host_starts = [h[0] for h in host]
    ranges.sort()
    range_starts = [r[0] for r in ranges]

    def around(t: int, items: list, starts: list, lookback: int):
        """The item with the latest start that still holds ``t``."""
        k = bisect.bisect_right(starts, t)
        for j in range(k - 1, max(-1, k - 1 - lookback), -1):
            if items[j][1] >= t:
                return items[j][2]
        return None

    gaps: dict = {}
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        where = around(mid, ranges, range_starts, len(ranges)) or "outside"
        what = around(mid, host, host_starts, _LOOKBACK) or "python"
        label = f"{where}: {what}"
        gaps[label] = gaps.get(label, 0) + (e - s)
    busy_ns = sum(e - s for s, e in busy)
    return TraceSummary(
        window_s=(hi - lo) / 1e9,
        busy_s=busy_ns / 1e9,
        half_device_s=half_ns / 1e9,
        device_ops=_top(by_name),
        idle_gaps=_top(gaps),
        device_events=len(device),
    )
