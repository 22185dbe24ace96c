"""Multiclass logistic regression, trained on the card.

Port of ``predictionio_tpu/models/logistic.py`` (the classification
config's "NaiveBayes -> logistic"): a softmax classifier trained by
full-batch Adam, ``steps`` steps from zero weights.  The reference runs
the steps under ``lax.scan`` with ``optax.adam(lr)``; here they are a
loop on the caller's device with autograd and ``torch.optim.Adam`` at its
defaults, which is optax's update exactly: β₁ 0.9, β₂ 0.999, ε 1e-8
added to the square root of the bias-corrected second moment (not
inside it), both moments bias-corrected.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, matmul_precision, resolve_device

__all__ = ["LogisticModel", "train_logistic"]


@dataclass
class LogisticModel:
    weights: np.ndarray  # [F, C]
    bias: np.ndarray     # [C]
    labels: np.ndarray   # [C]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        logits = np.atleast_2d(x) @ self.weights + self.bias
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def predict(self, x: np.ndarray) -> np.ndarray:
        logits = np.atleast_2d(x) @ self.weights + self.bias
        return self.labels[np.argmax(logits, axis=-1)]


def train_logistic(
    features: np.ndarray,
    labels: np.ndarray,
    lr: float = 0.1,
    steps: int = 300,
    l2: float = 1e-4,
    device: DeviceLike = "cuda",
) -> LogisticModel:
    """Minimize the mean softmax cross-entropy plus ``l2 * ||W||²`` in
    f32 on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    classes, y = np.unique(labels, return_inverse=True)
    yt = torch.as_tensor(y.reshape(-1), dtype=torch.int64, device=dev)
    n_f, n_c = x.shape[1], len(classes)

    w = torch.zeros((n_f, n_c), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((n_c,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr)
    with torch.enable_grad(), matmul_precision("highest"):
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            logits = x @ w + b
            ll = torch.log_softmax(logits, dim=1).gather(1, yt[:, None])
            loss = -ll.mean() + l2 * (w ** 2).sum()
            loss.backward()
            opt.step()
    return LogisticModel(
        weights=w.detach().cpu().numpy(),
        bias=b.detach().cpu().numpy(),
        labels=classes,
    )
