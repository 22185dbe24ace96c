"""Categorical Naive Bayes on string features (port of
``predictionio_tpu/e2/naive_bayes.py``).

Re-expression of reference `e2/engine/CategoricalNaiveBayes.scala:23-170`:
labels and per-position categorical string features; training counts
(label, position, value) triples; the model scores with configurable default
log-likelihood for unseen values (the reference's ``defaultLikelihood``
function parameter).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

__all__ = ["LabeledPoint", "CategoricalNaiveBayesModel", "train_categorical_nb"]


@dataclass(frozen=True)
class LabeledPoint:
    label: str
    features: tuple[str, ...]


def _default_likelihood(likelihoods: list[float]) -> float:
    """Reference default: log of a vanishing likelihood for unseen values."""
    return min(likelihoods) - math.log(len(likelihoods) + 1) if likelihoods \
        else float("-inf")


@dataclass
class CategoricalNaiveBayesModel:
    priors: dict[str, float]  # label -> log prior
    likelihoods: dict[str, list[dict[str, float]]]  # label -> per-pos value->loglik
    default_likelihood: Callable[[list[float]], float] = field(
        default=_default_likelihood
    )

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Optional[Callable[[list[float]], float]] = None,
    ) -> Optional[float]:
        """Joint log score of (label, features); None for unknown label
        (reference `logScore`)."""
        if point.label not in self.priors:
            return None
        dl = default_likelihood or self.default_likelihood
        return self._log_score_internal(point.label, point.features, dl)

    def _log_score_internal(self, label, features, dl) -> float:
        per_pos = self.likelihoods[label]
        total = self.priors[label]
        for pos, value in enumerate(features):
            table = per_pos[pos] if pos < len(per_pos) else {}
            if value in table:
                total += table[value]
            else:
                total += dl(list(table.values()))
        return total

    def predict(self, features: Sequence[str]) -> str:
        """argmax label (reference `predict`); ties / all -inf scores fall
        back to the first label so a label is always returned."""
        best, best_score = None, float("-inf")
        for label in self.priors:
            s = self._log_score_internal(
                label, tuple(features), self.default_likelihood
            )
            if best is None or s > best_score:
                best, best_score = label, s
        return best


def train_categorical_nb(
    points: Sequence[LabeledPoint],
) -> CategoricalNaiveBayesModel:
    """Count-based training (reference `CategoricalNaiveBayes.train`)."""
    if not points:
        raise ValueError("no training points")
    n_pos = len(points[0].features)
    label_count: dict[str, int] = {}
    value_count: dict[str, list[dict[str, int]]] = {}
    for p in points:
        label_count[p.label] = label_count.get(p.label, 0) + 1
        per_pos = value_count.setdefault(
            p.label, [dict() for _ in range(n_pos)]
        )
        for pos, v in enumerate(p.features):
            per_pos[pos][v] = per_pos[pos].get(v, 0) + 1
    total = sum(label_count.values())
    priors = {
        lb: math.log(c) - math.log(total) for lb, c in label_count.items()
    }
    likelihoods = {
        lb: [
            {
                v: math.log(c) - math.log(label_count[lb])
                for v, c in table.items()
            }
            for table in per_pos
        ]
        for lb, per_pos in value_count.items()
    }
    return CategoricalNaiveBayesModel(priors=priors, likelihoods=likelihoods)
