"""The engine registry: a new engine is one file.

Port of ``predictionio_tpu/engines``: ``spec.py`` holds the
:class:`EngineSpec` registry (declare and register by decorator),
``discovery.py`` finds engines (the port's built-in ``templates/``
package and user dirs on ``PIO_TPU_ENGINE_PATH``), and :func:`resolve`
is the dispatch point of the CLI's ``--engine NAME``.
"""

from __future__ import annotations

from typing import Optional

from .discovery import ENGINE_PATH_ENV, discover
from .spec import (
    ConformanceFixture,
    EngineSpec,
    clear_registry,
    engine_label_of,
    engine_spec,
    get_engine_spec,
    list_engine_specs,
    register,
    spec_name_of,
)

__all__ = [
    "ConformanceFixture",
    "EngineSpec",
    "ENGINE_PATH_ENV",
    "clear_registry",
    "discover",
    "engine_label_of",
    "engine_spec",
    "get_engine_spec",
    "list_engine_specs",
    "register",
    "resolve",
    "spec_name_of",
]


def resolve(name: str, variant_overrides: Optional[dict] = None):
    """``(engine, engine_params, variant)`` for a registered engine name,
    the no-engine.json form of ``cli.main.load_engine_from_variant``.
    ``variant_overrides`` replace same-named component keys of the
    spec's default variant."""
    spec = get_engine_spec(name)
    variant = spec.default_variant()
    if variant_overrides:
        variant.update({k: v for k, v in variant_overrides.items()
                        if v is not None})
    engine = spec.build()
    return engine, engine.params_from_variant(variant), variant
