"""Random forest classifier: trees as tensors.

Port of ``predictionio_tpu/models/forest.py`` (the reference's
`RandomForestAlgorithm`, `examples/scala-parallel-classification/
add-algorithm/src/main/scala/RandomForestAlgorithm.scala:1-60`, MLlib
``RandomForest.trainClassifier``):

* **Training is on the host** (numpy): CART split search is
  data-dependent control flow.  Bootstrap and per-split feature
  sampling, gini impurity, exact threshold search vectorized over the
  candidate splits — the reference's code, with the same
  ``np.random.default_rng`` stream, so the trees come out bit for bit.
* **Prediction is on the caller's device**: every tree is a complete
  binary tree in tensor layout (node ``i`` -> children ``2i+1 / 2i+2``),
  so a forest is three arrays — ``feature[t, n]`` (-1 marks a leaf),
  ``threshold[t, n]``, ``label[t, n]`` — and classifying a batch is
  ``max_depth`` lock-step ``torch.gather`` steps over (batch x trees),
  then a one-hot majority vote.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["ForestConfig", "ForestModel", "train_forest", "forest_predict"]


@dataclass(frozen=True)
class ForestConfig:
    n_trees: int = 16
    max_depth: int = 6
    num_classes: int = 2
    # features sampled per split: sqrt/auto, log2, onethird, all (the
    # reference's MLlib featureSubsetStrategy vocabulary)
    feature_subset: str = "sqrt"
    min_samples_split: int = 2
    seed: int = 0


@dataclass
class ForestModel:
    """Flat complete-binary-tree tensors: [n_trees, 2**(max_depth+1)-1]."""

    feature: np.ndarray     # int32; -1 = leaf
    threshold: np.ndarray   # float32; go left if x[f] <= thr
    label: np.ndarray       # int32 majority label at every node
    num_classes: int
    # input feature width (for the deploy-time warm-up of the batch
    # walk); -1 on models persisted before this field existed
    n_features: int = -1

    @property
    def max_depth(self) -> int:
        n = self.feature.shape[1]
        return int(np.log2(n + 1)) - 1


def _gini_split(xcol: np.ndarray, onehot: np.ndarray):
    """Best threshold on one feature column by gini; returns
    (impurity, threshold) or (inf, 0) when no split exists.

    ``onehot`` is the node's [n, num_classes] label matrix, built ONCE
    per node by the caller and re-permuted here — rebuilding it for each
    of the k sampled features was the hottest wasted work in training.
    """
    order = np.argsort(xcol, kind="stable")
    xs = xcol[order]
    # candidate boundaries: positions where consecutive x differ
    diff = np.nonzero(xs[1:] != xs[:-1])[0]
    if len(diff) == 0:
        return np.inf, 0.0
    n = len(xs)
    left_counts = np.cumsum(onehot[order], axis=0)  # counts for split at i
    total = left_counts[-1]
    li = left_counts[diff]                        # [C?, num_classes]
    ri = total - li
    nl = li.sum(axis=1)
    nr = ri.sum(axis=1)
    gini_l = 1.0 - ((li / nl[:, None]) ** 2).sum(axis=1)
    gini_r = 1.0 - ((ri / nr[:, None]) ** 2).sum(axis=1)
    w = (nl * gini_l + nr * gini_r) / n
    b = int(np.argmin(w))
    ix = diff[b]
    thr = (xs[ix] + xs[ix + 1]) / 2.0
    return float(w[b]), float(thr)


def _subset_size(strategy: str, n_feat: int) -> int:
    """Features sampled per split (the reference's MLlib
    featureSubsetStrategy values); unknown strategies are an error, not a
    silent fallback."""
    if strategy in ("sqrt", "auto"):
        return max(1, int(np.sqrt(n_feat)))
    if strategy == "log2":
        return max(1, int(np.log2(max(n_feat, 2))))
    if strategy == "onethird":
        return max(1, n_feat // 3)
    if strategy == "all":
        return n_feat
    raise ValueError(
        f"unknown feature_subset {strategy!r}: "
        "expected sqrt/auto/log2/onethird/all"
    )


def _fit_tree(X, y, cfg: ForestConfig, rng: np.random.Generator,
              feature, threshold, label) -> None:
    """Fill one tree's row of the flat tensors."""
    n_nodes = feature.shape[0]
    n_feat = X.shape[1]
    k = _subset_size(cfg.feature_subset, n_feat)
    # worklist of (node index, row indices); traversal order is free —
    # each entry carries its own complete-binary-tree index, children are
    # always enqueued as 2i+1 / 2i+2
    todo: list[tuple[int, np.ndarray]] = [(0, np.arange(len(y)))]
    while todo:
        node, rows = todo.pop()
        ys = y[rows]
        counts = np.bincount(ys, minlength=cfg.num_classes)
        label[node] = int(np.argmax(counts))
        is_last_level = 2 * node + 2 >= n_nodes
        if (
            is_last_level
            or len(rows) < cfg.min_samples_split
            or counts.max() == len(rows)     # pure node
        ):
            continue  # stays a leaf (feature == -1)
        feats = rng.choice(n_feat, size=k, replace=False)
        onehot = np.zeros((len(ys), cfg.num_classes), np.float64)
        onehot[np.arange(len(ys)), ys] = 1.0
        best = (np.inf, 0.0, -1)
        for f in feats:
            imp, thr = _gini_split(X[rows, f], onehot)
            if imp < best[0]:
                best = (imp, thr, int(f))
        if not np.isfinite(best[0]):
            continue  # no separating feature among the sampled ones
        _, thr, f = best
        go_left = X[rows, f] <= thr
        if not go_left.any() or go_left.all():
            continue
        feature[node] = f
        threshold[node] = thr
        todo.append((2 * node + 1, rows[go_left]))
        todo.append((2 * node + 2, rows[~go_left]))


def train_forest(
    X: np.ndarray, y: np.ndarray, cfg: ForestConfig = ForestConfig()
) -> ForestModel:
    """Bootstrap-aggregated CART trees (host-side; see module docstring)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    if len(X) == 0:
        raise ValueError("empty training data")
    n_nodes = 2 ** (cfg.max_depth + 1) - 1
    feature = np.full((cfg.n_trees, n_nodes), -1, np.int32)
    threshold = np.zeros((cfg.n_trees, n_nodes), np.float32)
    label = np.zeros((cfg.n_trees, n_nodes), np.int32)
    rng = np.random.default_rng(cfg.seed)
    for t in range(cfg.n_trees):
        boot = rng.integers(0, len(y), size=len(y))
        _fit_tree(
            X[boot], y[boot], cfg, rng, feature[t], threshold[t], label[t]
        )
    return ForestModel(
        feature=feature, threshold=threshold, label=label,
        num_classes=cfg.num_classes, n_features=X.shape[1],
    )


def _predict_device(x, feature, threshold, label, *, max_depth: int,
                    num_classes: int):
    """[B, F] -> (labels [B], votes [B, num_classes]).

    ``max_depth`` lock-step gather steps over every (row, tree) pair: at
    a leaf (feature == -1) the comparison is a no-op and the node stays
    put, so no pair needs control flow of its own.  The feature index is
    clamped to 0 before the gather (a leaf's -1 would index out of
    range; its result is discarded)."""
    B, T = x.shape[0], feature.shape[0]
    node = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    feat_b = feature[None].expand(B, -1, -1)
    thr_b = threshold[None].expand(B, -1, -1)
    for _ in range(max_depth):
        f = feat_b.gather(2, node[..., None])[..., 0]            # [B, T]
        thr = thr_b.gather(2, node[..., None])[..., 0]
        xv = x.gather(1, f.clamp(min=0))                        # [B, T]
        nxt = torch.where(xv <= thr, 2 * node + 1, 2 * node + 2)
        node = torch.where(f < 0, node, nxt)
    leaf_lab = label[None].expand(B, -1, -1).gather(
        2, node[..., None])[..., 0]                            # [B, T]
    votes = torch.nn.functional.one_hot(
        leaf_lab, num_classes).to(torch.float32).sum(dim=1)
    return torch.argmax(votes, dim=1), votes


def forest_predict(
    model: ForestModel, X: np.ndarray, return_votes: bool = False,
    device: DeviceLike = "cuda",
):
    """Majority-vote classification of a batch on ``device``; host
    arrays come back."""
    dev = resolve_device(device)
    X = np.atleast_2d(np.asarray(X, np.float32))
    labels, votes = _predict_device(
        torch.as_tensor(X, device=dev),
        torch.as_tensor(model.feature, dtype=torch.int64, device=dev),
        torch.as_tensor(model.threshold, device=dev),
        torch.as_tensor(model.label, dtype=torch.int64, device=dev),
        max_depth=model.max_depth, num_classes=model.num_classes,
    )
    labels = labels.to(torch.int32).cpu().numpy()
    votes = votes.cpu().numpy()
    return (labels, votes) if return_votes else labels
