"""The plain measure of what the sampling profiler records: steps of the
program's traced graph, run node by node, with the card fenced and the
host clock read wherever the run passes from one top-level vertex's
nodes to another's.  A vertex's time is the sum of its stretches, the
least over the steps.

It follows the program's own graph and vertices, on the program's own
state (the profiler's product is their times, which nothing else
defines), and shares no code with the profiler."""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, Sequence

import torch


class _Fenced(torch.fx.Interpreter):
    def __init__(self, gm: torch.fx.GraphModule, vertex_of: Dict,
                 device: torch.device):
        super().__init__(gm)
        self.vertex_of, self.device = vertex_of, device
        self.times: Dict[int, float] = {}
        self.open = None
        self.t0 = 0.0

    def switch(self, vertex) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self.open is not None:
            self.times[self.open] = self.times.get(self.open, 0.0) \
                + now - self.t0
        self.open, self.t0 = vertex, now

    def run_node(self, n: torch.fx.Node):
        v = self.vertex_of.get(n)
        if v is not None and v != self.open:
            self.switch(v)
        return super().run_node(n)


def vertex_times(gm: torch.fx.GraphModule, vertex_of: Dict,
                 flat_args: Sequence[torch.Tensor], device: torch.device,
                 runs: int = 2) -> Dict[int, float]:
    """Seconds by vertex id of a run of ``gm`` on ``flat_args``, the least
    over ``runs`` runs; ``vertex_of`` maps a node to its top-level
    vertex.  Python's garbage collector is held off during a run, so
    that no pause of its lands in a vertex."""
    best: Dict[int, float] = {}
    for _ in range(runs):
        run = _Fenced(gm, vertex_of, device)
        gc.collect()
        gc.disable()
        try:
            run.switch(None)
            with torch.no_grad():
                run.run(*flat_args)
            run.switch(None)
        finally:
            gc.enable()
        for v, t in run.times.items():
            best[v] = min(t, best.get(v, t))
        del run
    return best


def shortfall(program: Dict[int, float], reference: Dict[int, float],
              floor: float = 0.03) -> float:
    """The worst vertex's shortfall: by how much the program's record of
    it falls short of the plain measure, against the larger of that
    measure and ``floor`` of the measure's whole step (a vertex of a few
    milliseconds moves by a millisecond or two from step to step).  A
    pause of the host's in a sampled step lengthens a vertex's record
    and reads nothing here; a record that misses a vertex's work, or
    gives it to another vertex, does."""
    total = sum(reference.values())
    if not total > 0:
        return math.nan
    worst = 0.0
    for v, r in reference.items():
        short = (r - program.get(v, 0.0)) / max(r, floor * total)
        worst = short if not short <= worst else worst   # NaN wins
    return worst
