"""k-fold data splitting helper (port of
``predictionio_tpu/e2/cross_validation.py``).

Re-expression of reference `e2/evaluation/CrossValidation.scala:33-63`
(``CommonHelperFunctions.splitData``): fold i's test set is every element
whose index ≡ i (mod k); output shape matches ``read_eval``:
``[(training_data, eval_info, [(query, actual)])]``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")

__all__ = ["split_data"]


def split_data(
    eval_k: int,
    dataset: Sequence[D],
    evaluator_info: EI,
    training_data_creator: Callable[[Sequence[D]], TD],
    query_creator: Callable[[D], Q],
    actual_creator: Callable[[D], A],
) -> list[Tuple[TD, EI, list[Tuple[Q, A]]]]:
    if eval_k < 1:
        raise ValueError("eval_k must be >= 1")
    out = []
    for fold in range(eval_k):
        train = [d for i, d in enumerate(dataset) if i % eval_k != fold]
        test = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        out.append(
            (
                training_data_creator(train),
                evaluator_info,
                [(query_creator(d), actual_creator(d)) for d in test],
            )
        )
    return out
