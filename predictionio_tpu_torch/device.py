"""Device choice and fence for the single-card port.

The counterpart of ``predictionio_tpu/parallel/mesh.py``'s device choice
and ``fence`` on one device.  Every entry point of the port takes a
``device`` argument that defaults to ``"cuda"``; the host is used only
when the caller asks for ``"cpu"`` (the tests do), and asking for the
card where there is none raises instead of running on the host.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

import torch

__all__ = ["DeviceLike", "fence", "matmul_precision", "resolve_device"]

DeviceLike = Union[str, torch.device]

# ALSConfig.matmul_precision values; only "highest" is exact f32
PRECISIONS = ("highest", "high", "default")


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it is a CUDA device
    and no card is visible, or when it is neither CUDA nor the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def fence(device: DeviceLike = "cuda") -> None:
    """Wait until the card has finished all work queued so far
    (``torch.cuda.synchronize``); nothing to wait for on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# Blocks of matmul_precision open in any thread, by kind; the TF32 flag
# is process-wide, so it is set from these counts under one lock.
_precision_lock = threading.Lock()
_open = {"exact": 0, "tf32": 0}
_saved_tf32 = False


def _apply_tf32() -> None:
    # an exact block anywhere keeps TF32 off: a "high" block that overlaps
    # one runs in true f32, never the other way round
    torch.backends.cuda.matmul.allow_tf32 = _open["exact"] == 0


@contextlib.contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """Scope the f32 matrix-product precision of the ALS path.

    ``"highest"`` means true f32 (TF32 off for every ``torch.matmul``,
    ``einsum`` and ``bmm`` inside the block); ``"high"`` and
    ``"default"`` allow TF32.  Blocks may overlap across threads: while
    any ``"highest"`` block is open TF32 stays off, and when the last
    block closes the setting from before the first is restored, so
    nothing leaks to the caller."""
    global _saved_tf32
    if precision not in PRECISIONS:
        raise ValueError(
            f"matmul precision must be one of {PRECISIONS}, got {precision!r}"
        )
    kind = "exact" if precision == "highest" else "tf32"
    with _precision_lock:
        if not any(_open.values()):
            _saved_tf32 = torch.backends.cuda.matmul.allow_tf32
        _open[kind] += 1
        _apply_tf32()
    try:
        yield
    finally:
        with _precision_lock:
            _open[kind] -= 1
            if any(_open.values()):
                _apply_tf32()
            else:
                torch.backends.cuda.matmul.allow_tf32 = _saved_tf32
