"""Carry state from the JAX package into the port.

Every function takes the JAX package's values as numpy arrays (or
objects whose fields are numpy arrays, read by attribute) and imports
nothing of it; the port keeps its own copies of the arrays and of the id
dictionaries.
The JAX trainer draws its initial factors from ``jax.random``, which
torch cannot reproduce; handing them over with :func:`factors_from_jax`
lets both packages start from the same ``U0``, ``V0``; with a mesh it
splits the reference's padded sharded tables (``[n_pad, R]``, ``n_pad``
a multiple of the mesh size) into the port's per-shard blocks, and
:func:`factors_to_jax` joins the blocks back.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.forest import ForestModel
from .models.logistic import LogisticModel
from .models.naive_bayes import NaiveBayesModel
from .storage.bimap import StringIndex
from .templates.ecommerce import ECommModel
from .templates.itemsimilarity import ItemSimilarityModel
from .templates.recommendation import ALSModel
from .templates.similarproduct import SimilarALSModel

__all__ = [
    "ecomm_model_from_jax",
    "factors_from_jax",
    "factors_to_jax",
    "forest_from_jax",
    "itemsimilarity_model_from_jax",
    "logistic_from_jax",
    "model_from_jax",
    "naive_bayes_from_jax",
    "similar_model_from_jax",
]


def _index(ix) -> StringIndex:
    """The port's own copy of an id index (anything with ``ids``)."""
    return StringIndex([str(s) for s in ix.ids])


def _props(props) -> dict:
    return {k: dict(v) for k, v in props.items()}


def factors_from_jax(U, V, device: DeviceLike = "cuda", mesh=None):
    """``(U, V)`` host arrays (a JAX ``ALSFactors``' fields or initial
    factors) -> float32 tensors on ``device``; with ``mesh``, each
    padded table -> this process's row blocks on the shards' devices
    (``parallel.mesh.shard_put``)."""
    if mesh is not None:
        from .parallel.mesh import shard_put

        return tuple(shard_put(np.array(a, np.float32), mesh)
                     for a in (U, V))
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.array(a, np.float32)).to(dev)
        for a in (U, V)
    )


def factors_to_jax(U, V, mesh=None):
    """The port's tables -> host float32 arrays in the reference's
    layout: per-shard blocks (with ``mesh``) are joined in shard order
    into the padded ``[n_pad, R]`` table."""
    def host(t):
        if mesh is not None:
            from .parallel.collectives import gather_shards

            t = torch.cat(gather_shards(t, mesh))
        return t.detach().float().cpu().numpy()

    return host(U), host(V)


def model_from_jax(model, device: DeviceLike = "cuda") -> ALSModel:
    """A JAX recommendation ``ALSModel`` (``user_factors``,
    ``item_factors``, ``users``/``items`` id indexes with an ``ids``
    array, ``item_props``) -> the port's :class:`ALSModel` on
    ``device``, with its own copies of the id dictionaries."""
    return ALSModel(
        user_factors=np.array(model.user_factors, np.float32),
        item_factors=np.array(model.item_factors, np.float32),
        users=_index(model.users),
        items=_index(model.items),
        item_props=_props(model.item_props),
        device=resolve_device(device),
    )


def similar_model_from_jax(model, device: DeviceLike = "cuda"
                           ) -> SimilarALSModel:
    """A JAX similarproduct ``SimilarALSModel`` (the row-normalized
    ``item_factors``, ``items``, ``item_props``) -> the port's."""
    return SimilarALSModel(
        item_factors=np.array(model.item_factors, np.float32),
        items=_index(model.items),
        item_props=_props(model.item_props),
        device=resolve_device(device),
    )


def ecomm_model_from_jax(model, device: DeviceLike = "cuda") -> ECommModel:
    """A JAX ecommerce ``ECommModel`` (both factor tables, both id
    indexes, ``item_props``, ``app_id``) -> the port's."""
    return ECommModel(
        user_factors=np.array(model.user_factors, np.float32),
        item_factors=np.array(model.item_factors, np.float32),
        users=_index(model.users),
        items=_index(model.items),
        item_props=_props(model.item_props),
        app_id=int(model.app_id),
        device=resolve_device(device),
    )


def itemsimilarity_model_from_jax(model, device: DeviceLike = "cuda"
                                  ) -> ItemSimilarityModel:
    """A JAX ``ItemSimilarityModel`` (the row-normalized table, ``items``,
    ``item_props``) -> the port's."""
    return ItemSimilarityModel(
        item_factors=np.array(model.item_factors, np.float32),
        items=_index(model.items),
        item_props=_props(model.item_props),
        device=resolve_device(device),
    )


def naive_bayes_from_jax(model) -> NaiveBayesModel:
    """A JAX ``NaiveBayesModel`` (log priors, log likelihoods, labels)."""
    return NaiveBayesModel(
        log_prior=np.array(model.log_prior, np.float32),
        log_likelihood=np.array(model.log_likelihood, np.float32),
        labels=np.array(model.labels),
    )


def logistic_from_jax(model) -> LogisticModel:
    """A JAX ``LogisticModel`` (weights, bias, labels)."""
    return LogisticModel(
        weights=np.array(model.weights, np.float32),
        bias=np.array(model.bias, np.float32),
        labels=np.array(model.labels),
    )


def forest_from_jax(model) -> ForestModel:
    """A JAX ``ForestModel``: the flat ``feature``, ``threshold`` and
    ``label`` tree tensors, the class count and the feature width."""
    return ForestModel(
        feature=np.array(model.feature, np.int32),
        threshold=np.array(model.threshold, np.float32),
        label=np.array(model.label, np.int32),
        num_classes=int(model.num_classes),
        n_features=int(model.n_features),
    )
