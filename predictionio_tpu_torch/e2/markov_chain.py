"""e2 Markov chain wrapper over string states (port of
``predictionio_tpu/e2/markov_chain.py``; reference
`e2/engine/MarkovChain.scala:25-90`)."""

from __future__ import annotations

from typing import Sequence

from ..models.markov import MarkovChainModel, train_markov_chain
from ..storage.bimap import StringIndex

__all__ = ["MarkovChain"]


class MarkovChain:
    """Train from (state, next_state) string pairs; predict next-state
    distributions over string states."""

    def __init__(self, model: MarkovChainModel, states: StringIndex):
        self.model = model
        self.states = states

    @staticmethod
    def train(
        transitions: Sequence[tuple[str, str]], top_n: int = 10
    ) -> "MarkovChain":
        states = StringIndex.from_values(
            [s for t in transitions for s in t]
        )
        frm = states.encode([a for a, _ in transitions])
        to = states.encode([b for _, b in transitions])
        model = train_markov_chain(frm, to, len(states), top_n=top_n)
        return MarkovChain(model, states)

    def predict(self, state: str) -> list[tuple[str, float]]:
        ix = self.states.get(state)
        if ix < 0:
            return []
        return [
            (self.states.id_of(j), p) for j, p in self.model.predict(ix)
        ]
