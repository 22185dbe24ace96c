"""Multinomial naive Bayes, fitted on the card.

Port of ``predictionio_tpu/models/naive_bayes.py`` (which replaces Spark
MLlib's ``NaiveBayes.train`` of the classification template,
`NaiveBayesAlgorithm.scala:16-28`): class priors and per-class feature
log-likelihoods over non-negative feature vectors, each one segment sum
(``index_add_``) on the caller's device, no per-row Python.  The model
is numpy arrays, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["NaiveBayesModel", "train_naive_bayes"]


@dataclass
class NaiveBayesModel:
    """log priors [C], log likelihoods [C, F], class labels [C]."""

    log_prior: np.ndarray
    log_likelihood: np.ndarray
    labels: np.ndarray

    def predict_log_scores(self, x: np.ndarray) -> np.ndarray:
        """[.., F] -> [.., C] joint log scores."""
        return x @ self.log_likelihood.T + self.log_prior

    def predict(self, x: np.ndarray) -> np.ndarray:
        """[.., F] -> predicted label per row."""
        scores = self.predict_log_scores(np.atleast_2d(x))
        return self.labels[np.argmax(scores, axis=-1)]


def train_naive_bayes(
    features: np.ndarray,
    labels: np.ndarray,
    lam: float = 1.0,
    device: DeviceLike = "cuda",
) -> NaiveBayesModel:
    """Multinomial NB with additive (Laplace) smoothing ``lam`` (MLlib
    semantics: lambda defaults to 1.0), in f32 on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    classes, y = np.unique(labels, return_inverse=True)
    yt = torch.as_tensor(y.reshape(-1), dtype=torch.int64, device=dev)
    n_classes = len(classes)

    class_count = torch.zeros(n_classes, dtype=torch.float32, device=dev)
    class_count.index_add_(0, yt, torch.ones(len(y), dtype=torch.float32,
                                             device=dev))
    feat_sum = torch.zeros((n_classes, x.shape[1]), dtype=torch.float32,
                           device=dev)
    feat_sum.index_add_(0, yt, x)                               # [C, F]

    log_prior = torch.log(class_count) - torch.log(class_count.sum())
    smoothed = feat_sum + lam
    log_lik = torch.log(smoothed) - torch.log(
        smoothed.sum(dim=1, keepdim=True)
    )
    return NaiveBayesModel(
        log_prior=log_prior.cpu().numpy(),
        log_likelihood=log_lik.cpu().numpy(),
        labels=classes,
    )
