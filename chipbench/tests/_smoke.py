"""A cell of ``BENCHMARK.json`` at the port's smoke size on the CPU: the
same runner, judge and reference as on the card, with the harness's look
for a card skipped.  Its limits are the cell's but ``vertex_time_short``'s:
at this size a vertex takes a few milliseconds or less, and the host's
jitter moves the CPU's times by a tenth of the step or more."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

from chipbench.harness import registry


CPU_VERTEX_TIME_SHORT = 0.5


def smoke_cell(config: str, *, seq_len: int = 64, batch: int = 2,
               seed: int = 2 ** 31 + 11, trace: bool = False) -> Dict:
    from repro_torch.configs import get_smoke
    bench = registry.benchmark()
    cfg = registry.config(bench, config)
    cfg = dict(cfg, arch=dataclasses.asdict(get_smoke(config)))
    wl = next(w for w in bench["workloads"] if w["config"] == config)
    traffic = dict(registry.traffic(wl["traffic"]), seq_len=seq_len,
                   batch=batch)
    return {"workload": wl["name"], "chips": 1, "config": cfg,
            "traffic": traffic, "seed": seed, "seconds": 0.5,
            "trace": trace, "t_start": time.perf_counter(), "device": "cpu",
            "limits": dict(registry.limits(wl["name"]),
                           vertex_time_short=CPU_VERTEX_TIME_SHORT)}
