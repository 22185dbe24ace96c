"""Recursive debug dumper for workflow data.

Port of ``predictionio_tpu/utils/debug.py``, the analogue of the
reference's `WorkflowUtils.debugString`
(`workflow/WorkflowUtils.scala:228-245`), which collects RDDs and walks
arrays/iterables.  Here the interesting container types are torch
tensors (summarized with shape, dtype and device; only the head is
copied to the host), numpy arrays, dataclasses and mappings.  Every
other value prints as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["debug_string"]

_MAX_ITEMS = 20
_HEAD = 8


def _head(flat: np.ndarray) -> str:
    return np.array2string(flat[:_HEAD], precision=4, separator=",",
                           threshold=_HEAD)


def _tensor_summary(x: torch.Tensor) -> str:
    shape = "x".join(map(str, x.shape)) or "scalar"
    parts = [f"{type(x).__name__}[{shape}] {x.dtype}", f"device={x.device}"]
    flat = x.detach().reshape(-1)[:_HEAD]
    if flat.numel():
        if flat.dtype == torch.bfloat16:   # numpy has no bfloat16
            flat = flat.float()
        parts.append(f"head={_head(flat.cpu().numpy())}")
    return " ".join(parts)


def _array_summary(x) -> str:
    shape = "x".join(map(str, x.shape)) or "scalar"
    parts = [f"{type(x).__name__}[{shape}] {x.dtype}"]
    flat = np.asarray(x).reshape(-1)
    if flat.size:
        parts.append(f"head={_head(flat)}")
    return " ".join(parts)


def debug_string(data: Any, depth: int = 0) -> str:
    """Human dump of arbitrarily nested workflow data structures."""
    if depth > 6:
        return "..."
    if data is None or isinstance(data, (bool, int, float, str, bytes)):
        return repr(data)
    if isinstance(data, torch.Tensor):
        return _tensor_summary(data)
    if hasattr(data, "shape") and hasattr(data, "dtype"):
        return _array_summary(data)
    if dataclasses.is_dataclass(data) and not isinstance(data, type):
        inner = ", ".join(
            f"{f.name}={debug_string(getattr(data, f.name), depth + 1)}"
            for f in dataclasses.fields(data)
        )
        return f"{type(data).__name__}({inner})"
    if isinstance(data, dict):
        items = list(data.items())[:_MAX_ITEMS]
        inner = ", ".join(
            f"{k!r}: {debug_string(v, depth + 1)}" for k, v in items
        )
        more = ", ..." if len(data) > _MAX_ITEMS else ""
        return "{" + inner + more + "}"
    if isinstance(data, (list, tuple, set, frozenset)):
        items = list(data)[:_MAX_ITEMS]
        inner = ",".join(debug_string(v, depth + 1) for v in items)
        more = ",..." if len(data) > _MAX_ITEMS else ""
        open_, close = ("[", "]") if isinstance(data, list) else ("(", ")")
        return f"{open_}{inner}{more}{close}"
    return repr(data)
