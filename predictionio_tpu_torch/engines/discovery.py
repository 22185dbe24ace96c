"""Engine discovery: built-in templates + ``PIO_TPU_ENGINE_PATH`` dirs.

Port of ``predictionio_tpu/engines/discovery.py``.  Two sources, one
registry:

* the port's built-in ``predictionio_tpu_torch.templates`` package —
  every non-underscore module is imported, and each module's
  ``@engine_spec(...)`` decorators register on import;
* user engine dirs named by ``PIO_TPU_ENGINE_PATH`` (``os.pathsep``
  separated).  Each dir holds an ``engine.json`` pointing at a module —
  ``engineModule`` (a module name resolved inside the dir, default
  ``engine``) or ``engineFactory`` (dotted path whose top segment is the
  module file).  The dir goes on ``sys.path``, the module is imported,
  and its decorators register with ``source=<dir>``: a from-scratch
  engine is ONE ``engine.py`` plus a two-line ``engine.json``.

Discovery is lazy and idempotent: the first registry read triggers it;
``discover(refresh=True)`` re-walks the env var (tests and long-lived
servers whose operator appends a dir).
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import pkgutil
import sys
import threading
from pathlib import Path

from . import spec as _spec

logger = logging.getLogger(__name__)

__all__ = ["discover", "load_engine_dir", "ENGINE_PATH_ENV"]

ENGINE_PATH_ENV = "PIO_TPU_ENGINE_PATH"

_lock = threading.Lock()
_done = False
_loaded_dirs: set[str] = set()


def discover(refresh: bool = False) -> None:
    global _done
    with _lock:
        if _done and not refresh:
            return
        _import_builtin_templates()
        for raw in os.environ.get(ENGINE_PATH_ENV, "").split(os.pathsep):
            raw = raw.strip()
            if raw:
                _load_user_dir(Path(raw))
        _done = True


def load_engine_dir(engine_dir) -> None:
    """Load one engine dir outside the env-var path (the
    ``--engine-json <dir>/engine.json`` form of a registry-named
    engine)."""
    with _lock:
        _load_user_dir(Path(engine_dir))


def _import_builtin_templates() -> None:
    from .. import templates

    for m in pkgutil.iter_modules(templates.__path__):
        if m.name.startswith("_"):
            continue
        importlib.import_module(f"{templates.__name__}.{m.name}")


def _load_user_dir(engine_dir: Path) -> None:
    """Import one user engine dir's module (idempotent per resolved
    path).  A broken dir logs and is skipped — one bad entry on the
    path must not take down every `pio-tpu` invocation."""
    try:
        key = str(engine_dir.resolve())
    except OSError:
        key = str(engine_dir)
    if key in _loaded_dirs:
        return
    variant_path = engine_dir / "engine.json"
    if not variant_path.exists():
        logger.warning(
            "%s on %s has no engine.json; skipping", engine_dir,
            ENGINE_PATH_ENV,
        )
        return
    try:
        variant = json.loads(variant_path.read_text())
    except (OSError, ValueError) as e:
        logger.warning("cannot read %s: %s; skipping", variant_path, e)
        return
    module = variant.get("engineModule")
    if not module:
        factory = variant.get("engineFactory", "")
        module = factory.split(".", 1)[0] if factory else "engine"
    candidate = engine_dir / f"{module}.py"
    if not candidate.exists() and not (engine_dir / module).is_dir():
        logger.warning(
            "%s names module %r but %s does not exist; skipping",
            variant_path, module, candidate,
        )
        return
    if key not in sys.path:
        sys.path.insert(0, key)
    # evict a same-named module loaded from a DIFFERENT dir (the
    # cli._engine_dir_on_path contract): user engine dirs all tend to
    # call their module `engine`
    mod = sys.modules.get(module)
    if mod is not None and getattr(mod, "__file__", None) != str(candidate):
        del sys.modules[module]
    prior_source = _spec._current_source
    _spec._current_source = key
    try:
        importlib.import_module(module)
        _loaded_dirs.add(key)
    except Exception:  # a broken user dir must not stop every command
        logger.exception(
            "engine dir %s failed to import (module %r); skipping",
            engine_dir, module,
        )
    finally:
        _spec._current_source = prior_source
