"""Carry state from the JAX package into the port.

Both take the JAX package's values as numpy arrays (or objects whose
fields are numpy arrays, read by attribute) and import nothing of it.
The JAX trainer draws its initial factors from ``jax.random``, which
torch cannot reproduce; handing them over with :func:`factors_from_jax`
lets both packages start from the same ``U0``, ``V0``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .storage.bimap import StringIndex
from .templates.recommendation import ALSModel

__all__ = ["factors_from_jax", "model_from_jax"]


def factors_from_jax(U, V, device: DeviceLike = "cuda"):
    """``(U, V)`` host arrays (a JAX ``ALSFactors``' fields or initial
    factors) -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.array(a, np.float32)).to(dev)
        for a in (U, V)
    )


def model_from_jax(model, device: DeviceLike = "cuda") -> ALSModel:
    """A JAX recommendation ``ALSModel`` (``user_factors``,
    ``item_factors``, ``users``/``items`` id indexes with an ``ids``
    array, ``item_props``) -> the port's :class:`ALSModel` on
    ``device``, with its own copies of the id dictionaries."""
    return ALSModel(
        user_factors=np.array(model.user_factors, np.float32),
        item_factors=np.array(model.item_factors, np.float32),
        users=StringIndex([str(s) for s in model.users.ids]),
        items=StringIndex([str(s) for s in model.items.ids]),
        item_props={k: dict(v) for k, v in model.item_props.items()},
        device=resolve_device(device),
    )
