"""Base controller abstractions: the typed contracts every engine component
implements.

Copy of ``predictionio_tpu/controller/base.py`` for the port: the
``WorkflowContext`` carries one device instead of a mesh, and the
storage the caller hands it or, by default, the process-wide registry
storage (``storage.registry.get_storage``), as in the reference.

Re-expression of the reference `core` base classes
(`PredictionIO core/src/main/scala/io/prediction/core/BaseAlgorithm.scala:29-52`,
`BaseDataSource.scala`, `BasePreparator.scala`, `BaseServing.scala`) and the
controller-level P/P2L/L taxonomy (`controller/{PAlgorithm,P2LAlgorithm,
LAlgorithm}.scala`).  The Spark trichotomy (distributed RDD model /
collected local model / local model) becomes an explicit
:class:`ModelPlacement` on one ``Algorithm`` base — SURVEY §2.7(3):

* ``DEVICE_SHARDED``  — model lives in device memory (PAlgorithm analogue).
* ``HOST_REPLICATED`` — trained on device, small enough to serialize and
  replicate to every serving host (P2LAlgorithm analogue).
* ``HOST``            — pure host model (LAlgorithm analogue).

``Doer`` reflective construction (`core/AbstractDoer.scala:24-48`) becomes
:func:`instantiate`: try 1-arg (params) constructor, fall back to 0-arg.
"""

from __future__ import annotations

import enum
from typing import Any, Generic, Optional, Sequence, Tuple, TypeVar

from ..device import DeviceLike, resolve_device
from .params import EmptyParams, Params

__all__ = [
    "ModelPlacement",
    "WorkflowContext",
    "DataSource",
    "Preparator",
    "IdentityPreparator",
    "Algorithm",
    "Serving",
    "FirstServing",
    "AverageServing",
    "SanityCheck",
    "instantiate",
    "TrainingInterrupted",
    "StopAfterReadInterruption",
    "StopAfterPrepareInterruption",
]

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")    # model
Q = TypeVar("Q")    # query
P = TypeVar("P")    # predicted result
A = TypeVar("A")    # actual result


class ModelPlacement(enum.Enum):
    DEVICE_SHARDED = "device_sharded"
    HOST_REPLICATED = "host_replicated"
    HOST = "host"


class WorkflowContext:
    """Per-run handle passed to every controller — the SparkContext analogue.

    Carries the device, the resolved storage, and run identity
    (`workflow/WorkflowContext.scala:25-44` parity: app name
    ``"PredictionIO <Mode>: <batch>"`` becomes :attr:`label`).  The device
    defaults to the card; ``device="cpu"`` runs on the host.  ``storage``
    defaults to the registry's (``$PIO_TPU_HOME``).
    """

    def __init__(self, device: DeviceLike = "cuda", storage=None,
                 mode: str = "Training", batch: str = "",
                 verbose: bool = False, mesh=None):
        self.device = resolve_device(device)
        if storage is None:
            from ..storage.registry import get_storage

            storage = get_storage()
        self.storage = storage
        self.mode = mode
        self.batch = batch
        self.verbose = verbose
        self._mesh = mesh

    @property
    def mesh(self):
        """The run's mesh of shards (``parallel/mesh.py``): the one
        handed in (``mesh=``), else built on first use: every visible
        card of this process on ``cuda``, one host shard on the CPU; in
        a multi-process run it spans every process (so each process
        must reach it, as the reference's collectives)."""
        if self._mesh is None:
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(
                devices=None if self.device.type == "cuda" else [self.device])
        return self._mesh

    @property
    def label(self) -> str:
        return f"PredictionIO-Torch {self.mode}: {self.batch}"


class SanityCheck:
    """Data classes may implement this; the train workflow calls it on
    training data, prepared data and models
    (reference `controller/SanityCheck.scala:24-30`)."""

    def sanity_check(self) -> None:
        raise NotImplementedError


class DataSource(Generic[TD, EI, Q, A]):
    """Reads training and evaluation data from the event store
    (reference `controller/PDataSource.scala:33-60` / `LDataSource.scala`)."""

    params: Params = EmptyParams()

    def read_training(self, ctx: WorkflowContext) -> TD:
        raise NotImplementedError

    def read_eval(
        self, ctx: WorkflowContext
    ) -> Sequence[Tuple[TD, EI, Sequence[Tuple[Q, A]]]]:
        """Eval sets: (training data, eval info, (query, actual) pairs)."""
        return []


class Preparator(Generic[TD, PD]):
    """TD -> PD (reference `controller/PPreparator.scala`)."""

    params: Params = EmptyParams()

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> PD:
        raise NotImplementedError


class IdentityPreparator(Preparator[TD, TD]):
    """Passthrough (reference `controller/IdentityPreparator.scala`)."""

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> TD:
        return training_data


class Algorithm(Generic[PD, M, Q, P]):
    """Train + predict (reference `core/BaseAlgorithm.scala:29-52`).

    ``batch_predict`` is the evaluation path (reference
    ``batchPredictBase``); the default maps ``predict`` over queries, device
    algorithms override it with one batched device call.
    """

    params: Params = EmptyParams()
    placement: ModelPlacement = ModelPlacement.HOST_REPLICATED

    def train(self, ctx: WorkflowContext, prepared_data: PD) -> M:
        raise NotImplementedError

    def warmup(self, model: M,  # noqa: B027 — optional hook
               max_batch: int = 64) -> None:
        """Pre-compile the scoring path at deploy time so the first real
        query doesn't pay one-time device set-up (kernel builds, library
        handles and allocator growth; reference deploys are warm because
        JVM models need none).  ``max_batch`` is the serving
        micro-batcher's configured maximum, so batched warmups can cover
        every batch size its pow2 padding will dispatch."""

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(self, model: M, queries: Sequence[Q]) -> list[P]:
        return [self.predict(model, q) for q in queries]

    # -- persistence hooks (reference makePersistentModel / PersistentModel) --
    def save_model(self, ctx: WorkflowContext, model_id: str, model: M,
                   base_dir) -> Optional[dict]:
        """Custom persistence: return a manifest dict, or None to use the
        framework default (checkpoint pytree / pickle).  Reference:
        `controller/PersistentModel.scala:48-95`."""
        return None

    def load_model(self, ctx: WorkflowContext, model_id: str, manifest: dict,
                   base_dir) -> M:
        """Inverse of :meth:`save_model` when it returned a manifest."""
        raise NotImplementedError

    @property
    def persist_model(self) -> bool:
        """False -> model is not persisted and deploy retrains (parity with
        PAlgorithm-without-PersistentModel, `controller/Engine.scala:186-208`).
        Default True: always checkpoint (SURVEY §7 hard-part 6)."""
        return True


class Serving(Generic[Q, P]):
    """Combine predictions from all algorithms into one response
    (reference `controller/LServing.scala:27-39`)."""

    params: Params = EmptyParams()

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError


class FirstServing(Serving[Q, P]):
    """Serve the first algorithm's prediction
    (reference `controller/LFirstServing.scala:25-39`)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """Average numeric predictions
    (reference `controller/LAverageServing.scala:25-41`)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)


class TrainingInterrupted(Exception):
    """Deliberate workflow interruption
    (reference `workflow/WorkflowUtils.scala:414-418`)."""


class StopAfterReadInterruption(TrainingInterrupted):
    pass


class StopAfterPrepareInterruption(TrainingInterrupted):
    pass


def _takes_params(cls: type) -> bool:
    import inspect

    try:
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError):
        return False
    args = [
        p
        for name, p in sig.parameters.items()
        if name != "self"
        and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    return len(args) >= 1


def instantiate(cls: type, params: Optional[Params] = None) -> Any:
    """`Doer.apply` analogue (`core/AbstractDoer.scala:24-48`): construct
    ``cls`` with the params if its constructor takes one, else 0-arg; either
    way attach ``params``.  Arity is decided by signature inspection so a
    genuine TypeError inside a constructor propagates instead of being
    masked by a 0-arg retry."""
    if params is not None and _takes_params(cls):
        obj = cls(params)
    else:
        obj = cls()
    if params is not None:
        obj.params = params
    elif not hasattr(obj, "params"):
        obj.params = EmptyParams()
    return obj
