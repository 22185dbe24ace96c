"""Profiler hooks for workflows: a ``torch.profiler`` trace of a block.

Port of ``predictionio_tpu/utils/profiling.py``, which wraps
``jax.profiler``.  Here the trace is a ``torch.profiler`` capture with
CPU activity, and CUDA activity where a card is present, exported as a
Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``)
under ``$PIO_TPU_HOME/profiles/<tag>``.  The traced block runs on the
caller's thread; the session starts and stops on the process's profiler
thread (``obs/timeline.py`` ``on_profiler_thread``), where every
``torch.profiler`` session of the port starts and stops, the captures
of ``GET /debug/profile`` included.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from pathlib import Path
from typing import Optional

from ..obs.timeline import on_profiler_thread

logger = logging.getLogger(__name__)

__all__ = ["profile_trace", "profiled", "profile_dir"]


def profile_dir(tag: str = "trace") -> Path:
    home = os.environ.get("PIO_TPU_HOME") or os.path.expanduser(
        "~/.predictionio_tpu"
    )
    p = Path(home) / "profiles" / tag
    p.mkdir(parents=True, exist_ok=True)
    return p


@contextlib.contextmanager
def profile_trace(tag: str = "trace", enabled: Optional[bool] = None):
    """Capture a trace of the enclosed block; yields its directory, or
    None when the hook is off.

    ``enabled=None`` reads ``PIO_TPU_PROFILE=1`` so production paths can
    carry the hook at no cost until it is switched on.
    """
    if enabled is None:
        enabled = os.environ.get("PIO_TPU_PROFILE") == "1"
    if not enabled:
        yield None
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    out = profile_dir(tag)
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    # every thread's ops: the session starts on the profiler thread, the
    # block runs on the caller's
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))

    on_profiler_thread(prof.start)
    if card:
        # device work of this thread, read back, in every session: on the
        # H100 a session whose block does none leaves every later capture
        # of the process without a CUDA kernel (PERF.md §6)
        x = torch.ones(8, 8, device="cuda")
        (x @ x).sum().item()

    def stop() -> None:
        if card:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))

    try:
        yield out
    finally:
        on_profiler_thread(stop)
    logger.info("profile '%s' captured in %.2fs -> %s",
                tag, time.perf_counter() - t0, out)


def profiled(tag: Optional[str] = None):
    """Decorator form of :func:`profile_trace`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with profile_trace(tag or fn.__qualname__):
                return fn(*a, **kw)

        return wrapper

    return deco
