"""The general token generator: a traffic file's rows of ids, made from
(seed, step) by NumPy's Philox, so that the same seed gives the same
stream and every step's rows differ.  ``tokens: "uniform"`` draws ids
uniformly over the vocabulary."""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenBatches:
    """The data set a Trainer reads: ``batch(i)`` is step ``offset + i``'s
    rows ``[row0, row0 + rows)`` of a ``(global_rows, seq_len + 1)``
    batch.  The runner moves ``offset`` between its calls, as each of the
    Trainer's calls numbers its steps from 0."""

    def __init__(self, traffic: Dict, vocab: int, seed: int,
                 rows: int, row0: int = 0, global_rows: int = 0):
        if traffic.get("tokens", "uniform") != "uniform":
            raise ValueError(f"tokens {traffic['tokens']!r}")
        self.vocab, self.seed = vocab, seed % (1 << 64)
        self.seq = traffic["seq_len"]
        self.rows, self.row0 = rows, row0
        self.global_rows = global_rows or rows
        self.offset = 0

    def tokens(self, step: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(key=[self.seed, step]))
        ids = rng.integers(0, self.vocab, (self.global_rows, self.seq + 1),
                           dtype=np.int32)
        return ids[self.row0:self.row0 + self.rows]

    def batch(self, i: int) -> Dict[str, np.ndarray]:
        return {"tokens": self.tokens(self.offset + i)}
