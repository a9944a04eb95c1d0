"""The numbers that decide ``correct``, each held against its limit."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest relative gap between the two sides' step losses."""
    if len(program) != len(reference):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(program, reference))


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    med = statistics.median(reference[n] for n in leaves)
    worst = 0.0
    for n in leaves:
        a = program.get(n, math.nan)
        gap = abs(a - reference[n]) / max(reference[n], med)
        worst = gap if not gap <= worst else worst      # NaN wins
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limit has a finite number at or under it."""
    return all(k in numbers and numbers[k] == numbers[k]
               and numbers[k] <= lim for k, lim in limits.items())
