"""Engine specs: the one-file-engine registry.

Port of ``predictionio_tpu/engines/spec.py``.  :class:`EngineSpec` is one
declaration per engine (factory, engine.json-shaped default params, a
query example, optionally the evaluation ``eval --engine NAME`` runs,
and a :class:`ConformanceFixture`), registered by decorator; the CLI's
``engines list/describe``, ``train/deploy/eval --engine NAME``, the
template gallery (``tools/template_gallery.py``), the serving metrics'
``engine`` label and the registry conformance suite
(``tests/test_torch_engine_conformance.py``, which drives every spec's
fixture train -> deploy -> query -> feedback -> eval) all read it.

Registration is a side effect of import: decorating a zero-arg factory
registers the spec, and :func:`~predictionio_tpu_torch.engines.discovery.
discover` imports the built-in ``templates/`` package and any user engine
dirs on ``PIO_TPU_ENGINE_PATH``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

__all__ = [
    "ConformanceFixture",
    "EngineSpec",
    "engine_spec",
    "register",
    "get_engine_spec",
    "list_engine_specs",
    "spec_name_of",
    "clear_registry",
]


@dataclass(frozen=True)
class ConformanceFixture:
    """What the conformance suite needs to drive an engine end to end
    with no engine-specific test code: the app to seed, its events, a
    tiny-train variant, queries to send and a predicate over each reply.

    ``seed_events`` is a zero-arg callable (not a literal list) so event
    times can be minted at run time."""

    app_name: str
    seed_events: Callable[[], Sequence[Any]]
    queries: tuple[dict, ...]
    check: Optional[Callable[[Any], bool]] = None
    # tiny-train variant; None = the spec's default_params (the suite
    # must take seconds an engine)
    variant: Optional[Mapping[str, Any]] = None


@dataclass(frozen=True)
class EngineSpec:
    """One engine, declared once.

    ``factory`` is the zero-arg callable producing the
    :class:`~predictionio_tpu_torch.controller.engine.Engine`;
    ``default_params`` is the engine.json-shaped component params dict
    (``datasource``/``preparator``/``algorithms``/``serving`` keys) that
    seeds both the template gallery's scaffold and ``--engine NAME``
    dispatch when no engine.json exists."""

    name: str
    description: str
    factory: Callable[[], Any]
    factory_path: str
    default_params: Mapping[str, Any] = field(default_factory=dict)
    query_example: Mapping[str, Any] = field(default_factory=dict)
    source: str = "builtin"
    # optional zero-arg callable returning a controller Evaluation —
    # `eval --engine NAME` dispatches through it
    evaluation: Optional[Callable[[], Any]] = None
    evaluation_path: Optional[str] = None
    conformance: Optional[ConformanceFixture] = None

    def build(self):
        """Factory call; the instance is stamped with the spec name, the
        label serving metrics and run manifests read."""
        engine = self.factory()
        engine._engine_spec_name = self.name
        return engine

    def default_variant(self) -> dict:
        """The synthetic engine.json of registry dispatch: ``engine``
        (not ``engineFactory``) is the loader key."""
        return {
            "id": self.name,
            "engine": self.name,
            "description": self.description,
            **{k: _plain(v) for k, v in self.default_params.items()},
        }

    def instance_variant_key(self) -> str:
        """The engine-variant string instances of ``--engine NAME`` are
        registered under."""
        return f"engine:{self.name}"

    def describe(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "factory": self.factory_path,
            "source": self.source,
            "defaultParams": _plain(self.default_params),
            "queryExample": _plain(self.query_example),
            "evaluation": self.evaluation_path,
            "conformance": self.conformance is not None,
        }


def _plain(v):
    """Deep-copy mappings/sequences to plain json-shaped types."""
    if isinstance(v, Mapping):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


_lock = threading.Lock()
_registry: dict[str, EngineSpec] = {}
# set by discovery while importing a user engine dir so decorators in
# that module register with the right provenance
_current_source: str = "builtin"


def register(spec: EngineSpec) -> EngineSpec:
    """Idempotent per (name, factory_path); a DIFFERENT factory under an
    existing name is a collision and raises."""
    with _lock:
        prior = _registry.get(spec.name)
        if prior is not None and prior.factory_path != spec.factory_path:
            raise ValueError(
                f"engine {spec.name!r} is already registered by "
                f"{prior.factory_path} (source: {prior.source}); "
                f"refusing to overwrite with {spec.factory_path}"
            )
        _registry[spec.name] = spec
    return spec


def engine_spec(
    name: str,
    *,
    description: str = "",
    default_params: Optional[Mapping[str, Any]] = None,
    query_example: Optional[Mapping[str, Any]] = None,
    evaluation: Optional[Callable[[], Any]] = None,
    conformance: Optional[ConformanceFixture] = None,
):
    """Decorator: register a zero-arg engine factory as an engine.  The
    decorated function keeps working as a plain factory, and the engines
    it returns are stamped with the spec name either way."""

    def wrap(factory: Callable[[], Any]):
        import functools

        @functools.wraps(factory)
        def stamped():
            engine = factory()
            engine._engine_spec_name = name
            return engine

        desc = description
        if not desc and factory.__doc__:
            desc = factory.__doc__.strip().splitlines()[0]
        spec = EngineSpec(
            name=name,
            description=desc,
            factory=stamped,
            factory_path=f"{factory.__module__}.{factory.__qualname__}",
            default_params=dict(default_params or {}),
            query_example=dict(query_example or {}),
            source=_current_source,
            evaluation=evaluation,
            evaluation_path=(
                f"{evaluation.__module__}.{evaluation.__qualname__}"
                if evaluation is not None else None
            ),
            conformance=conformance,
        )
        register(spec)
        stamped.__engine_spec__ = spec
        return stamped

    return wrap


def spec_name_of(obj: Any) -> Optional[str]:
    """The registered engine name of an Engine instance (or of a
    decorated factory), or None for engines built outside the
    registry."""
    name = getattr(obj, "_engine_spec_name", None)
    if name is not None:
        return name
    spec = getattr(obj, "__engine_spec__", None)
    return spec.name if spec is not None else None


def engine_label_of(engine: Any, fallback: str = "custom") -> str:
    """The metrics label of an engine instance: its registered spec
    name, else ``fallback``."""
    return spec_name_of(engine) or fallback


def get_engine_spec(name: str) -> EngineSpec:
    from .discovery import discover

    discover()
    with _lock:
        spec = _registry.get(name)
        if spec is None:
            known = ", ".join(sorted(_registry)) or "(none)"
            raise KeyError(
                f"no engine named {name!r} is registered; known: {known}"
                " — set PIO_TPU_ENGINE_PATH to add user engine dirs"
            )
        return spec


def list_engine_specs() -> list[EngineSpec]:
    from .discovery import discover

    discover()
    with _lock:
        return sorted(_registry.values(), key=lambda s: s.name)


def clear_registry(keep_builtin: bool = True) -> None:
    """Test hook: drop user-dir registrations (or everything)."""
    with _lock:
        if keep_builtin:
            for k in [k for k, s in _registry.items()
                      if s.source != "builtin"]:
                del _registry[k]
        else:
            _registry.clear()
