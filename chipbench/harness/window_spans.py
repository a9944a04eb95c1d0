"""The program's host spans and collector counters over the measured
window, for the readers of the span metrics.

A run record may hold them under ``spans``: ``{"window": the totals of
the window's ``Trainer.train`` calls summed, "trace": the profiler's
``trace_spans``}``, each ``{name: {"count", "seconds", "longest"}}``.
Where it does not, they are read from the program's own record of its
last calls (``repro_torch.core.spans.recent()``), in a run with a device
trace only (a traced run on the card, whose trace holds the same spans
as ranges): the trailing ``Trainer.train`` calls that hold the window's
steps, whose ``trainer.step`` spans are the run's ``step_wall_s``.  A
program without spans gives None."""
from __future__ import annotations

from typing import Dict, List, Optional

Totals = Dict[str, Dict[str, float]]


def summed(entries: List[Totals]) -> Totals:
    out: Totals = {}
    for entry in entries:
        for name, st in entry.items():
            o = out.setdefault(name, {"count": 0, "seconds": 0.0,
                                      "longest": 0.0})
            o["count"] += st["count"]
            o["seconds"] += st["seconds"]
            o["longest"] = max(o["longest"], st["longest"])
    return out


def _from_program(run: Dict) -> Optional[Dict[str, Totals]]:
    walls = run.get("step_wall_s")
    if not run.get("trace") or not walls:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    recent = spans.recent()
    calls, steps = [], 0
    for scope, totals in reversed(recent):
        if scope != "trainer.train" or steps >= len(walls):
            break
        calls.append(totals)
        steps += totals.get("trainer.step", {}).get("count", 0)
    window = summed(calls)
    step = window.get("trainer.step")
    if (steps != len(walls) or step is None
            or abs(step["seconds"] - sum(walls)) > 1e-6 * len(walls)):
        return None
    trace = next((t for scope, t in reversed(recent)
                  if scope == "profiler.init"), {})
    return {"window": window, "trace": trace}


def of_run(run: Dict) -> Optional[Dict[str, Totals]]:
    """``{"window": totals, "trace": totals}``, or None."""
    return run["spans"] if "spans" in run else _from_program(run)


def seconds(totals: Totals, *names: str) -> float:
    return sum(totals[n]["seconds"] for n in names if n in totals)


def count(totals: Totals, name: str) -> int:
    return int(totals.get(name, {}).get("count", 0))
