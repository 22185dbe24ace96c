"""FastEvalEngine: prefix-memoized evaluation across a params sweep.

Copy of ``predictionio_tpu/controller/fast_eval.py`` for the port, with
one addition: a held-out set carried as columns (the recommendation
template's ``read_eval``) is served as columns (:meth:`FastEvalEngine.
_batch_serve`), the same triples without one Python object per rating.

Re-expression of reference `controller/FastEvalEngine.scala:45-330`: during
``batch_eval`` over many EngineParams candidates, pipeline stages whose
*params prefix* matches a previous candidate reuse its results instead of
recomputing — a sweep varying only algorithm params re-reads and re-prepares
nothing.  Cache keys mirror the reference's ``DataSourcePrefix`` /
``PreparatorPrefix`` / ``AlgorithmsPrefix`` / ``ServingPrefix``.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any

from .base import FirstServing, WorkflowContext
from .engine import Engine, EngineParams

logger = logging.getLogger(__name__)

__all__ = ["FastEvalEngine"]


_OPAQUE = itertools.count()
# __slots__ objects can't carry the token; pin them (strong ref) so their
# address can never be reused by a different params object while this
# process lives — id() is then a safe identity key.  Bounded by the number
# of distinct slotted-no-repr params candidates ever evaluated (rare).
_OPAQUE_PINNED: dict[int, tuple[int, Any]] = {}


def _key(named_params) -> Any:
    """Hashable key for a (name, Params) pair or list thereof.

    Params without value semantics (no custom ``__repr__`` — the default
    one embeds a reusable memory address) key on OBJECT IDENTITY via a
    token stamped on the instance: the same object keeps hitting the
    cache (trivially equal to itself), but a different object never
    aliases it even when the allocator reuses the address — the
    reference's "not cached when isEqual is not implemented" rule
    (`FastEvalEngineTest.scala:131`).  Keying on the raw default repr
    would silently alias two different candidates on address reuse.
    """
    if isinstance(named_params, list):
        return tuple(_key(x) for x in named_params)
    name, params = named_params
    if params is not None and type(params).__repr__ is object.__repr__:
        try:
            tok = params.__dict__.setdefault(
                "_pio_opaque_token", next(_OPAQUE)
            )
        except AttributeError:  # __slots__ object: pin + identity token
            tok = _OPAQUE_PINNED.setdefault(
                id(params), (next(_OPAQUE), params)
            )[0]
        return (name, f"opaque-{tok}")
    return (name, repr(params))


class FastEvalEngine(Engine):
    """Evaluation-only engine with pipeline-prefix caching.

    Not for training/deploy (reference restricts it the same way:
    `FastEvalEngine.scala:297-330`).
    """

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], Engine) and len(args) == 1 and not kwargs:
            e = args[0]
            super().__init__(
                e.data_source_class_map,
                e.preparator_class_map,
                e.algorithm_class_map,
                e.serving_class_map,
            )
        else:
            super().__init__(*args, **kwargs)
        self._ds_cache: dict = {}
        self._prep_cache: dict = {}
        self._algo_cache: dict = {}
        # hit/miss counters (FastEvalEngineTest asserts on these)
        self.stats = {"ds": 0, "prep": 0, "algo": 0}

    # -- cached stages ----------------------------------------------------
    def _get_eval_sets(self, ctx, ep: EngineParams):
        key = _key(ep.data_source)
        if key not in self._ds_cache:
            self.stats["ds"] += 1
            ds = self._data_source(ep)
            t0 = time.perf_counter()
            self._ds_cache[key] = ds.read_eval(ctx)
            logger.info("read_eval: %.3f s", time.perf_counter() - t0)
        return self._ds_cache[key]

    def _get_prepared(self, ctx, ep: EngineParams):
        key = (_key(ep.data_source), _key(ep.preparator))
        if key not in self._prep_cache:
            self.stats["prep"] += 1
            prep = self._preparator(ep)
            eval_sets = self._get_eval_sets(ctx, ep)
            self._prep_cache[key] = [
                (prep.prepare(ctx, td), ei, qa) for td, ei, qa in eval_sets
            ]
        return self._prep_cache[key]

    def _get_models(self, ctx, ep: EngineParams):
        key = (
            _key(ep.data_source),
            _key(ep.preparator),
            _key(list(ep.algorithms)),
        )
        if key not in self._algo_cache:
            self.stats["algo"] += 1
            algorithms = self._algorithms(ep)
            prepared = self._get_prepared(ctx, ep)
            self._algo_cache[key] = (
                algorithms,
                [
                    [algo.train(ctx, pd) for algo in algorithms]
                    for pd, _, _ in prepared
                ],
            )
        return self._algo_cache[key]

    # -- eval using the caches --------------------------------------------
    def eval(self, ctx: WorkflowContext, engine_params: EngineParams,
             workflow_params=None):
        serving = self._serving(engine_params)
        prepared = self._get_prepared(ctx, engine_params)
        algorithms, per_set_models = self._get_models(ctx, engine_params)
        results = []
        for s, ((pd, ei, qa), models) in enumerate(
                zip(prepared, per_set_models)):
            t0 = time.perf_counter()
            results.append(
                (ei, self._batch_serve(algorithms, models, serving, qa))
            )
            logger.info("eval set %d: %d queries served in %.3f s", s,
                        len(qa), time.perf_counter() - t0)
        return results

    @staticmethod
    def _batch_serve(algorithms, models, serving, qa):
        """A held-out set carried as columns (the recommendation
        template's ``read_eval``, ``served``/``queries``) with one
        algorithm and first-prediction serving is served as columns: the
        queries, the predictions and the ``(query, prediction, actual)``
        triples stay columns, the same elements in the same order as the
        generic path's list.  Anything else takes the generic path."""
        served = getattr(qa, "served", None)
        if (served is not None and len(algorithms) == 1
                and type(serving).serve is FirstServing.serve):
            return served(algorithms[0].batch_predict(models[0],
                                                      qa.queries()))
        return Engine._batch_serve(algorithms, models, serving, qa)

    def clear_cache(self) -> None:
        self._ds_cache.clear()
        self._prep_cache.clear()
        self._algo_cache.clear()
        self.stats = {"ds": 0, "prep": 0, "algo": 0}
