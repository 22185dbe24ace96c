"""Engine: the 4-component pipeline (DataSource -> Preparator -> Algorithm(s)
-> Serving) plus params plumbing.

Copy of ``predictionio_tpu/controller/engine.py`` for the port.

Re-expression of reference `controller/Engine.scala` (class `Engine`
`:78-450`, object-level `train`/`eval` `:583-772`) and
`controller/EngineParams.scala:31-105`.  Differences by design:

* name -> class maps are explicit dict registries, not JVM reflection;
* the training substrate is a :class:`~predictionio_tpu_torch.controller.base.
  WorkflowContext` (one device) instead of SparkContext;
* ``engine.json`` variant parsing (`jValueToEngineParams`,
  `Engine.scala:328-384`) lands on dataclass params via
  :func:`~predictionio_tpu_torch.controller.params.extract_params`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Generic, Mapping, Optional, Sequence, Tuple

from .base import (
    A,
    Algorithm,
    DataSource,
    EI,
    FirstServing,
    IdentityPreparator,
    P,
    PD,
    Preparator,
    Q,
    Serving,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    TD,
    WorkflowContext,
    instantiate,
)
from .params import Params, extract_params

logger = logging.getLogger(__name__)

__all__ = ["EngineParams", "Engine", "SimpleEngine", "EngineFactory"]


class EngineParams:
    """Named (DataSource, Preparator, [Algorithm], Serving) params 4-tuple
    (reference `controller/EngineParams.scala:31-83`)."""

    def __init__(
        self,
        data_source: Tuple[str, Optional[Params]] = ("", None),
        preparator: Tuple[str, Optional[Params]] = ("", None),
        algorithms: Sequence[Tuple[str, Optional[Params]]] = (("", None),),
        serving: Tuple[str, Optional[Params]] = ("", None),
    ):
        self.data_source = data_source
        self.preparator = preparator
        self.algorithms = list(algorithms)
        self.serving = serving

    def copy(self, **kw) -> "EngineParams":
        d = dict(
            data_source=self.data_source,
            preparator=self.preparator,
            algorithms=self.algorithms,
            serving=self.serving,
        )
        d.update(kw)
        return EngineParams(**d)

    def __repr__(self) -> str:
        return (
            f"EngineParams(ds={self.data_source}, prep={self.preparator}, "
            f"algos={self.algorithms}, serving={self.serving})"
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, EngineParams) and (
            self.data_source,
            self.preparator,
            self.algorithms,
            self.serving,
        ) == (other.data_source, other.preparator, other.algorithms, other.serving)

    def __hash__(self):
        return hash(
            (self.data_source, self.preparator, tuple(self.algorithms), self.serving)
        )


def _as_class_map(x) -> dict[str, type]:
    if isinstance(x, Mapping):
        return dict(x)
    return {"": x}


class Engine(Generic[TD, EI, PD, Q, P, A]):
    """The engine: component class maps + orchestration."""

    def __init__(
        self,
        data_source_class_map,
        preparator_class_map,
        algorithm_class_map,
        serving_class_map,
        params_validator=None,
    ):
        self.data_source_class_map = _as_class_map(data_source_class_map)
        self.preparator_class_map = _as_class_map(preparator_class_map)
        self.algorithm_class_map = _as_class_map(algorithm_class_map)
        self.serving_class_map = _as_class_map(serving_class_map)
        # optional callable(EngineParams) raising on CROSS-component
        # inconsistencies (per-component fields validate themselves in
        # their dataclasses; couplings like the recommendation
        # template's coo='local' <-> factorPlacement='sharded' need the
        # whole tuple).  Runs at params construction — config errors
        # surface at build/validate time, not after minutes of ingest
        self.params_validator = params_validator

    def validate_params(self, ep: EngineParams) -> None:
        if self.params_validator is not None:
            self.params_validator(ep)

    # -- component construction ------------------------------------------
    def _data_source(self, ep: EngineParams) -> DataSource:
        name, params = ep.data_source
        return instantiate(self._lookup(self.data_source_class_map, name,
                                        "datasource"), params)

    def _preparator(self, ep: EngineParams) -> Preparator:
        name, params = ep.preparator
        return instantiate(self._lookup(self.preparator_class_map, name,
                                        "preparator"), params)

    def _algorithms(self, ep: EngineParams) -> list[Algorithm]:
        return [
            instantiate(self._lookup(self.algorithm_class_map, name, "algorithm"),
                        params)
            for name, params in ep.algorithms
        ]

    def _serving(self, ep: EngineParams) -> Serving:
        name, params = ep.serving
        return instantiate(self._lookup(self.serving_class_map, name, "serving"),
                           params)

    @staticmethod
    def _lookup(cmap: dict[str, type], name: str, kind: str) -> type:
        if name in cmap:
            return cmap[name]
        if name == "" and len(cmap) == 1:
            return next(iter(cmap.values()))
        raise KeyError(
            f"{kind} '{name}' not found in engine definition; "
            f"existing name(s): {sorted(cmap)}"
        )

    # -- train (Engine.scala:135-167 + object Engine.train :583-670) -------
    def train(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        workflow_params=None,
    ) -> list[Any]:
        _, models = self.train_components(ctx, engine_params, workflow_params)
        return models

    def train_components(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        workflow_params=None,
        algo_indices: Optional[Sequence[int]] = None,
    ) -> Tuple[list[Algorithm], list[Any]]:
        """Train and return the *trained component instances* alongside the
        models (so persistence hooks see any state built during train).
        ``algo_indices`` restricts training to a subset of algorithms
        (partial retrain at deploy); the returned lists still cover only
        that subset, in index order.
        """
        from ..workflow.params import WorkflowParams

        wp = workflow_params or WorkflowParams()
        data_source = self._data_source(engine_params)
        preparator = self._preparator(engine_params)
        algorithms = self._algorithms(engine_params)
        if algo_indices is not None:
            algorithms = [algorithms[i] for i in algo_indices]

        t0 = time.perf_counter()
        td = data_source.read_training(ctx)
        logger.info("read_training: %.3f s", time.perf_counter() - t0)
        if not wp.skip_sanity_check:
            _sanity(td, "training data")
        if wp.stop_after_read:
            raise StopAfterReadInterruption("stop-after-read requested")

        pd = preparator.prepare(ctx, td)
        if not wp.skip_sanity_check:
            _sanity(pd, "prepared data")
        if wp.stop_after_prepare:
            raise StopAfterPrepareInterruption("stop-after-prepare requested")

        models = []
        for i, algo in enumerate(algorithms):
            logger.info("training algorithm %d: %s", i, type(algo).__name__)
            model = algo.train(ctx, pd)
            if not wp.skip_sanity_check:
                _sanity(model, f"model {i}")
            models.append(model)
        return algorithms, models

    # -- eval (Engine.scala:289-326 + object Engine.eval :688-772) ----------
    def eval(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        workflow_params=None,
    ) -> list[Tuple[Any, list[Tuple[Any, Any, Any]]]]:
        """Per eval set: (eval info, [(query, prediction, actual)])."""
        data_source = self._data_source(engine_params)
        preparator = self._preparator(engine_params)
        algorithms = self._algorithms(engine_params)
        serving = self._serving(engine_params)
        return self._eval_with(ctx, data_source, preparator, algorithms, serving)

    def _eval_with(self, ctx, data_source, preparator, algorithms, serving):
        t0 = time.perf_counter()
        eval_sets = data_source.read_eval(ctx)
        logger.info("read_eval: %.3f s", time.perf_counter() - t0)
        results = []
        for s, (td, ei, qa) in enumerate(eval_sets):
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
            t0 = time.perf_counter()
            results.append((ei, self._batch_serve(algorithms, models, serving, qa)))
            logger.info("eval set %d: %d queries served in %.3f s", s,
                        len(qa), time.perf_counter() - t0)
        return results

    @staticmethod
    def _batch_serve(algorithms, models, serving, qa) -> list[Tuple[Any, Any, Any]]:
        queries = [q for q, _ in qa]
        per_algo = [
            algo.batch_predict(model, queries)
            for algo, model in zip(algorithms, models)
        ]
        out = []
        for i, (q, a) in enumerate(qa):
            preds = [pp[i] for pp in per_algo]
            out.append((q, serving.serve(q, preds), a))
        return out

    # -- batch eval over many candidates (BaseEngine.batchEval) -------------
    def batch_eval(
        self, ctx: WorkflowContext, engine_params_list: Sequence[EngineParams],
        workflow_params=None,
    ):
        return [
            (ep, self.eval(ctx, ep, workflow_params)) for ep in engine_params_list
        ]

    # -- engine.json variant parsing (Engine.scala:328-384) ------------------
    def _spec_to_params(
        self, spec: Mapping[str, Any], cmap: dict[str, type], kind: str
    ) -> Tuple[str, Optional[Params]]:
        name = spec.get("name", "")
        cls = self._lookup(cmap, name, kind)
        params_cls = getattr(cls, "params_class", None)
        raw = spec.get("params")
        if params_cls is None:
            return (name, None if raw is None else _DictParams(raw))
        return (name, extract_params(params_cls, raw))

    def params_from_variant(self, variant: Mapping[str, Any]) -> EngineParams:
        def comp(key: str, cmap: dict[str, type]) -> Tuple[str, Optional[Params]]:
            spec = variant.get(key)
            if spec is None:
                return ("", None)
            return self._spec_to_params(spec, cmap, key)

        algorithms = [
            self._spec_to_params(spec, self.algorithm_class_map, "algorithm")
            for spec in variant.get("algorithms", [])
        ] or [("", None)]

        ep = EngineParams(
            data_source=comp("datasource", self.data_source_class_map),
            preparator=comp("preparator", self.preparator_class_map),
            algorithms=algorithms,
            serving=comp("serving", self.serving_class_map),
        )
        self.validate_params(ep)
        return ep

    def params_from_instance(self, instance) -> EngineParams:
        """EngineInstance record -> the exact EngineParams it was trained
        with (deploy must serve with the trained params, not whatever the
        current engine.json says — reference `engineInstanceToEngineParams`,
        `controller/Engine.scala:386-450`)."""
        import json as _json

        def one(js: str, cmap: dict[str, type], kind: str):
            d = _json.loads(js) if js else {}
            if not d:
                return ("", None)
            ((name, params),) = d.items()
            return self._spec_to_params(
                {"name": name, "params": params}, cmap, kind
            )

        algorithms = [
            self._spec_to_params(
                {"name": name, "params": params},
                self.algorithm_class_map, "algorithm",
            )
            for spec in _json.loads(instance.algorithms_params or "[]")
            for name, params in spec.items()
        ] or [("", None)]
        return EngineParams(
            data_source=one(instance.data_source_params,
                            self.data_source_class_map, "datasource"),
            preparator=one(instance.preparator_params,
                           self.preparator_class_map, "preparator"),
            algorithms=algorithms,
            serving=one(instance.serving_params,
                        self.serving_class_map, "serving"),
        )


class _DictParams(Params):
    """Fallback params wrapper when an algorithm declares no params_class."""

    def __init__(self, d: Mapping[str, Any]):
        self.fields = dict(d)

    def __eq__(self, other):
        return isinstance(other, _DictParams) and self.fields == other.fields

    def __hash__(self):
        return hash(tuple(sorted(self.fields.items())))

    def __repr__(self):
        return f"_DictParams({self.fields})"


class SimpleEngine(Engine[TD, EI, TD, Q, P, A]):
    """DataSource + single algorithm, identity preparator, first serving
    (reference `EngineParams.scala:98-105`)."""

    def __init__(self, data_source_class, algorithm_class):
        super().__init__(
            data_source_class,
            IdentityPreparator,
            algorithm_class,
            FirstServing,
        )


class EngineFactory:
    """Engines are produced by zero-arg factories named in engine.json's
    ``engineFactory`` (reference `controller/EngineFactory.scala:29-34`);
    subclass or use any callable returning an Engine."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def engine_params(self, key: str) -> EngineParams:
        raise KeyError(f"no engine params for key {key}")


def _sanity(obj: Any, what: str) -> None:
    # duck-typed: anything exposing sanity_check() participates
    # (SanityCheck subclassing is optional, unlike the reference trait)
    check = getattr(obj, "sanity_check", None)
    if callable(check):
        logger.info("sanity check on %s", what)
        check()
