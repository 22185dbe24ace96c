"""e2: reusable engine-building library (port of ``predictionio_tpu/e2``,
after the reference system's `e2/` module: framework-independent
helpers usable from any engine)."""

from .naive_bayes import CategoricalNaiveBayesModel, train_categorical_nb
from .markov_chain import MarkovChain
from .cross_validation import split_data

__all__ = [
    "CategoricalNaiveBayesModel",
    "train_categorical_nb",
    "MarkovChain",
    "split_data",
]
