"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) read here.  The same seed gives the same inputs,
and every seed gives the same set of sizes in another order, so the work
of a run does not depend on its seed.

Requests: prompt lengths cycle through the grid ``prompt_len`` (``min``
to ``max`` by ``step``), each pass of the grid in an order drawn from
the seed; token ids are uniform over the vocabulary, drawn from a stream
of their own for each request.  Training batches: ``rows`` sequences of
``seq`` uniform token ids a step, the labels the next ids."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _rng(seed: int, *counter: int) -> np.random.Generator:
    c = list(counter) + [0] * (4 - len(counter))
    return np.random.Generator(np.random.Philox(key=int(seed), counter=c))


class Requests:
    def __init__(self, mix: dict, seed: int, vocab: int):
        p = mix["prompt_len"]
        self.grid: List[int] = list(range(p["min"], p["max"] + 1, p["step"]))
        self.seed = seed
        self.vocab = vocab
        self.gen_tokens = int(mix["gen_tokens"])
        self._orders: Dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        k, j = divmod(i, len(self.grid))
        if k not in self._orders:
            self._orders[k] = _rng(self.seed, 1, k).permutation(len(self.grid))
        return self.grid[int(self._orders[k][j])]

    def prompt(self, i: int) -> np.ndarray:
        return _rng(self.seed, 2, i).integers(
            0, self.vocab, size=self.length(i), dtype=np.int32)


class Batches:
    def __init__(self, mix: dict, seed: int, vocab: int):
        t = mix["train"]
        self.rows, self.seq = int(t["rows"]), int(t["seq"])
        self.seed = seed
        self.vocab = vocab

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq

    def at(self, step: int) -> Dict[str, np.ndarray]:
        ids = _rng(self.seed, 3, step).integers(
            0, self.vocab, size=(self.rows, self.seq + 1), dtype=np.int32)
        return {"tokens": np.ascontiguousarray(ids[:, :-1]),
                "labels": np.ascontiguousarray(ids[:, 1:])}
