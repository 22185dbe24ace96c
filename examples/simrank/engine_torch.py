"""Parallel SimRank friend recommendation (Delta-SimRank analogue; the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
reference's jitted ``lax.fori_loop`` becomes a Python loop of the two
[n, n] products on ``ctx.device`` in true f32 (torch ops, where the
reference runs XLA: no kernel of its own).

Analogue of the reference `examples/experimental/
scala-parallel-friend-recommendation/` (`SimRankAlgorithm.scala`,
`DeltaSimRankRDD.scala`, `Sampling.scala`), which computes SimRank with
the Delta-SimRank message-passing scheme on Spark GraphX — delta
propagation exists because a full dense iteration is shuffle-bound on a
cluster, and node/forest-fire sampling data sources shrink the graph
first.

Device shape: the SimRank fixed point

    S ← max(c · Wᵀ S W, I)        (W = column-normalized adjacency)

is two dense [n, n] matmuls per iteration, so the delta machinery
disappears.  The reference's three data sources carry over
as three named DataSource classes (full graph / node sampling /
forest-fire sampling), selected by ``"datasource": {"name": ...}`` in
engine.json, and its `normalizeGraph` vertex-id remapping is the
`StringIndex` contiguous encoding.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.device import matmul_precision
from predictionio_tpu_torch.storage.bimap import StringIndex


@dataclass(frozen=True)
class DataSourceParams(Params):
    graph_edgelist_path: str = "edge_list_small.txt"
    sample_fraction: float = 0.5
    seed: int = 7

    def __post_init__(self):
        if not 0.0 < self.sample_fraction <= 1.0:
            raise ValueError(
                f"sample_fraction must be in (0, 1], got "
                f"{self.sample_fraction}"
            )


@dataclass(frozen=True)
class AlgoParams(Params):
    num_iterations: int = 7    # 6-8 recommended by the SimRank papers
    decay: float = 0.8


@dataclass
class Query:
    user: str
    num: int = 4


@dataclass
class FriendScore:
    user: str
    score: float


@dataclass
class GraphData:
    vertices: StringIndex
    adjacency: np.ndarray  # [n, n] float32, symmetric 0/1


def _read_edges(path: str) -> list[tuple[str, str]]:
    edges = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2 and not line.lstrip().startswith("#"):
            edges.append((parts[0], parts[1]))
    return edges


def _to_graph(edges: list[tuple[str, str]]) -> GraphData:
    vertices = StringIndex.from_values(v for e in edges for v in e)
    n = len(vertices)
    adj = np.zeros((n, n), np.float32)
    for a, b in edges:
        ia, ib = vertices[a], vertices[b]
        if ia != ib:
            # friendship is mutual: symmetrize the edge list
            adj[ia, ib] = adj[ib, ia] = 1.0
    return GraphData(vertices, adj)


class FullGraphDataSource(DataSource):
    """The whole edge list (reference ``DataSource``)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> GraphData:
        return _to_graph(_read_edges(self.params.graph_edgelist_path))


class NodeSamplingDataSource(FullGraphDataSource):
    """Uniform node sample with induced edges (reference
    ``NodeSamplingDataSource``, `Sampling.scala` nodeSampling)."""

    def read_training(self, ctx) -> GraphData:
        edges = _read_edges(self.params.graph_edgelist_path)
        nodes = sorted({v for e in edges for v in e})
        rng = np.random.default_rng(self.params.seed)
        keep_n = max(2, int(len(nodes) * self.params.sample_fraction))
        keep = set(rng.choice(nodes, size=keep_n, replace=False))
        return _to_graph([e for e in edges if e[0] in keep and e[1] in keep])


class ForestFireSamplingDataSource(FullGraphDataSource):
    """Forest-fire sample (reference ``ForestFireSamplingDataSource``):
    burn outward from random seeds, each burn igniting a geometric
    number of unvisited neighbors, until the node budget is reached."""

    def read_training(self, ctx) -> GraphData:
        edges = _read_edges(self.params.graph_edgelist_path)
        nbrs: dict[str, set[str]] = {}
        for a, b in edges:
            nbrs.setdefault(a, set()).add(b)
            nbrs.setdefault(b, set()).add(a)
        nodes = sorted(nbrs)
        rng = np.random.default_rng(self.params.seed)
        budget = max(2, int(len(nodes) * self.params.sample_fraction))
        burned: set[str] = set()
        frontier: list[str] = []
        while len(burned) < budget:
            if not frontier:
                unburned = [v for v in nodes if v not in burned]
                frontier.append(unburned[rng.integers(len(unburned))])
                burned.add(frontier[0])
            v = frontier.pop()
            cand = [u for u in sorted(nbrs[v]) if u not in burned]
            if cand:
                k = min(len(cand), 1 + rng.geometric(0.5))
                for u in rng.choice(cand, size=k, replace=False):
                    if len(burned) >= budget:
                        break
                    burned.add(str(u))
                    frontier.append(str(u))
        return _to_graph(
            [e for e in edges if e[0] in burned and e[1] in burned]
        )


@dataclass
class SimRankModel:
    vertices: StringIndex
    scores: np.ndarray  # [n, n] SimRank, diag 1


class SimRankAlgorithm(Algorithm):
    """Dense SimRank as a two-product iteration on the device (the
    Delta-SimRank map/reduce triple collapsed into matrix products)."""

    params_class = AlgoParams

    def train(self, ctx, g: GraphData) -> SimRankModel:
        n = g.adjacency.shape[0]
        deg = g.adjacency.sum(axis=0)
        W = torch.as_tensor(g.adjacency / np.maximum(deg, 1.0),
                            device=ctx.device)          # column-norm
        eye = torch.eye(n, dtype=torch.float32, device=ctx.device)
        S = eye
        with matmul_precision("highest"):
            for _ in range(self.params.num_iterations):
                S = self.params.decay * (W.T @ S @ W)
                S = S * (1.0 - eye) + eye   # SimRank(a, a) = 1
        return SimRankModel(g.vertices, S.cpu().numpy())

    def predict(self, model: SimRankModel, query: Query):
        ix = model.vertices.get(query.user)
        if ix < 0:
            return []
        row = model.scores[ix].copy()
        row[ix] = -np.inf                      # never recommend yourself
        top = np.argsort(row)[::-1][: query.num]
        return [
            FriendScore(user=str(model.vertices.id_of(j)),
                        score=float(row[j]))
            for j in top
            if np.isfinite(row[j]) and row[j] > 0
        ]


def engine_factory() -> Engine:
    return Engine(
        {
            "": FullGraphDataSource,
            "full": FullGraphDataSource,
            "node": NodeSamplingDataSource,
            "forestfire": ForestFireSamplingDataSource,
        },
        IdentityPreparator,
        {"simrank": SimRankAlgorithm, "": SimRankAlgorithm},
        FirstServing,
    )
