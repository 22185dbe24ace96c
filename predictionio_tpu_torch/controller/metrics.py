"""Metric family for evaluation.

Copy of ``predictionio_tpu/controller/metrics.py`` for the port (host
NumPy code, the same numbers).

Re-expression of reference `controller/Metric.scala:36-218`: a ``Metric``
scores the full evaluation output (eval info + (query, prediction, actual)
triples per eval set); helper bases reduce per-point scores with one-pass
vectorized stats (the reference uses Spark ``StatCounter``; here the points
land in NumPy and reduce in one shot).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, Optional, Sequence, Tuple, TypeVar

import numpy as np

from .base import A, EI, P, Q, WorkflowContext

R = TypeVar("R")

__all__ = [
    "Metric",
    "ActualItems",
    "AverageMetric",
    "MAPatK",
    "OptionAverageMetric",
    "StdevMetric",
    "OptionStdevMetric",
    "SumMetric",
    "QPAMetric",
    "ZeroMetric",
]

EvalData = Sequence[Tuple[Any, Sequence[Tuple[Any, Any, Any]]]]


class Metric(Generic[EI, Q, P, A, R]):
    """Base metric: ``calculate`` over all eval sets; ``compare`` orders
    results (default: larger is better — override for losses)."""

    def calculate(self, ctx: WorkflowContext, data: EvalData) -> R:
        raise NotImplementedError

    def compare(self, a: R, b: R) -> int:
        if a == b:
            return 0
        return 1 if a > b else -1

    @property
    def header(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.header


class _PointMetric(Metric[EI, Q, P, A, float]):
    """Shared machinery: map points -> floats, reduce with stats.

    ``strict=True`` raises when a point returns None (the non-Option metric
    variants); otherwise None points are skipped."""

    def calculate_point(self, query, predicted, actual) -> Optional[float]:
        raise NotImplementedError

    def _points(self, data: EvalData, strict: bool = False) -> np.ndarray:
        vals = []
        for _, qpa in data:
            for q, p, a in qpa:
                s = self.calculate_point(q, p, a)
                if s is None:
                    if strict:
                        raise ValueError(
                            f"{type(self).__name__}.calculate_point returned "
                            "None; use the Option* metric variant"
                        )
                    continue
                vals.append(s)
        return np.asarray(vals, dtype=np.float64)


class AverageMetric(_PointMetric):
    """Mean of per-point scores (reference `Metric.scala:87-100`).  A point
    returning None raises — use OptionAverageMetric for optional points."""

    def calculate(self, ctx, data) -> float:
        arr = self._points(data, strict=True)
        return float(arr.mean()) if len(arr) else float("nan")


class OptionAverageMetric(_PointMetric):
    """Mean over points that returned a value (`Metric.scala:112-125`)."""

    def calculate(self, ctx, data) -> float:
        arr = self._points(data)
        return float(arr.mean()) if len(arr) else float("nan")


class StdevMetric(_PointMetric):
    """Population stdev of per-point scores (`Metric.scala:139`)."""

    def calculate(self, ctx, data) -> float:
        arr = self._points(data, strict=True)
        return float(arr.std()) if len(arr) else float("nan")


class OptionStdevMetric(_PointMetric):
    def calculate(self, ctx, data) -> float:
        arr = self._points(data)
        return float(arr.std()) if len(arr) else float("nan")


class SumMetric(_PointMetric):
    """Sum of per-point scores (`Metric.scala:193-211`)."""

    def calculate(self, ctx, data) -> float:
        arr = self._points(data)
        return float(arr.sum())


class QPAMetric(Metric[EI, Q, P, A, R]):
    """Marker base for metrics consuming (Q, P, A) directly
    (`Metric.scala:216`)."""


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always 0 — placeholder metric (reference `ZeroMetric`)."""

    def calculate(self, ctx, data) -> float:
        return 0.0


# -- ranking metrics ------------------------------------------------------------


@dataclass(frozen=True)
class ActualItems:
    """Ranking-eval ground truth: the held-out relevant item set for
    one query (the analogue of ``ActualRating`` for top-k engines)."""

    items: tuple[str, ...]


class MAPatK(_PointMetric):
    """Mean Average Precision at k over ranked predictions.

    Per point: the prediction's ordered ``item_scores`` are cut at k
    and scored against the actual's relevant item SET with the
    standard AP@k —

        ``sum_i( precision@i * rel(i) ) / min(k, |relevant|)``

    (reference e2's ranking metrics family; the normalizer caps at k
    so a query with more relevant items than the cutoff can still
    score 1.0).  Points with an empty relevant set are skipped
    (Option semantics — nothing to rank against is not a zero)."""

    def __init__(self, k: int = 10):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    @property
    def header(self) -> str:
        return f"MAP@{self.k}"

    @staticmethod
    def _ranked_items(predicted) -> list:
        scores = getattr(predicted, "item_scores", None)
        if scores is None and isinstance(predicted, dict):
            scores = predicted.get("itemScores", ())
        out = []
        for s in scores or ():
            item = getattr(s, "item", None)
            if item is None and isinstance(s, dict):
                item = s.get("item")
            out.append(str(item))
        return out

    def calculate_point(self, query, predicted, actual) -> Optional[float]:
        relevant = set(getattr(actual, "items", ()) or ())
        if not relevant:
            return None
        ranked = self._ranked_items(predicted)[: self.k]
        hits = 0
        ap = 0.0
        for i, item in enumerate(ranked):
            if item in relevant:
                hits += 1
                ap += hits / (i + 1)
        return ap / min(self.k, len(relevant))

    def calculate(self, ctx, data) -> float:
        arr = self._points(data)
        return float(arr.mean()) if len(arr) else float("nan")
