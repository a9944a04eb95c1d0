"""Real-model step traces: the scenario bank's PPG source.

A :class:`StepTrace` is one profiled jitted step (train or decode) of a
model from the zoo, captured once by the JAX package
(``python -m repro.scenarios.record``) and committed as JSON under
``scenarios/traces/``, so the bank replays from the JSON alone.  A trace
holds:

  * the contracted PSG from the JAX package's ``GraphProfiler``
    over the real step function (sampled timing, state kept resident
    between steps),
  * per-vertex mean base times (seconds, measured on the recording host),
  * the collective mix of the step's compiled sharded HLO
    (the JAX package's ``hlo_walk.analyze_hlo`` over a
    ``launch.shardings.build_cell`` lowering), aggregated per kind with
    the replica-group LAYOUT recorded as a scale-free pattern.

Replica groups are recorded on a handful of host devices but scenarios
replay at 512-2048 procs, so groups are not stored literally: each
collective keeps a pattern — ``consecutive`` runs of fixed size (a model/
tensor axis), ``strided`` groups (a data axis laid out across the model
axis), or ``global`` — and :func:`instantiate_psg` re-materializes the
matching groups at the target scale, appending one Comm vertex per
collective to a fresh copy of the PSG.  ``ring`` patterns materialize
p2p pairs instead (pipeline-style neighbor exchange).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import COMM, PSG

TRACE_DIR = Path(__file__).resolve().parent / "traces"

PATTERNS = ("consecutive", "strided", "global", "ring")


@dataclasses.dataclass(frozen=True)
class GroupPattern:
    """Scale-free replica-group layout.

    ``consecutive``: groups are runs ``[a, a+1, ..., a+size-1]`` — the
    model/tensor axis of a row-major (data, model) mesh.  ``strided``:
    ``size`` groups of stride ``size`` — the data axis of the same mesh.
    ``global``: one group over every process.  ``ring``: ordered p2p
    pairs ``(p, (p+1) % n)`` — neighbor exchange, not a replica group.
    """
    layout: str                  # one of PATTERNS
    size: int = 1                # consecutive: group size; strided: stride

    def groups_at(self, n_procs: int) -> List[List[int]]:
        if self.layout == "consecutive":
            g = max(int(self.size), 1)
            return [list(range(s, min(s + g, n_procs)))
                    for s in range(0, n_procs, g)]
        if self.layout == "strided":
            s = max(int(self.size), 1)
            return [list(range(r, n_procs, s)) for r in range(min(s, n_procs))]
        if self.layout == "global":
            return [list(range(n_procs))]
        raise ValueError(f"{self.layout!r} has no replica groups")

    def pairs_at(self, n_procs: int) -> List[Tuple[int, int]]:
        if self.layout != "ring":
            raise ValueError(f"{self.layout!r} has no p2p pairs")
        return [(p, (p + 1) % n_procs) for p in range(n_procs)]


def classify_groups(groups: Sequence[Sequence[int]],
                    n_devices: int) -> GroupPattern:
    """Recorded replica groups -> scale-free :class:`GroupPattern`.

    Recognizes the two layouts a row-major (data, model) mesh produces —
    consecutive runs (model axis) and constant-stride combs (data axis);
    anything else degrades to ``global`` (safe: a global barrier is the
    conservative over-approximation for wait propagation).
    """
    gs = [list(g) for g in groups if len(g)]
    if not gs or sum(len(g) for g in gs) >= n_devices and len(gs) == 1:
        return GroupPattern("global")
    sizes = {len(g) for g in gs}
    if len(sizes) == 1:
        size = sizes.pop()
        if all(g == list(range(g[0], g[0] + size)) for g in gs):
            return GroupPattern("consecutive", size)
        stride = len(gs)
        if size > 1 and all(
                g == list(range(g[0], g[0] + stride * size, stride))
                for g in gs):
            return GroupPattern("strided", stride)
    return GroupPattern("global")


@dataclasses.dataclass
class CollectiveSpec:
    """One aggregated collective of the recorded step's compiled HLO."""
    kind: str                    # all-reduce | all-to-all | all-gather | ...
    bytes: float                 # summed payload across instances
    count: int                   # instances aggregated
    pattern: GroupPattern
    order: int = 0               # first-occurrence rank in the HLO program

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CollectiveSpec":
        d = dict(d)
        d["pattern"] = GroupPattern(**d["pattern"])
        return cls(**d)


@dataclasses.dataclass
class StepTrace:
    """One recorded jitted step: PSG + base times + collective mix."""
    name: str
    arch: str
    kind: str                    # train | decode | prefill
    psg: PSG
    base: Dict[int, float]       # vid -> mean seconds on the recording host
    collectives: List[CollectiveSpec]
    recorded_devices: int = 1
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "arch": self.arch, "kind": self.kind,
            "recorded_devices": self.recorded_devices, "mesh": self.mesh,
            "meta": self.meta,
            "base": {str(k): v for k, v in sorted(self.base.items())},
            "collectives": [c.to_dict() for c in self.collectives],
            "psg": json.loads(self.psg.to_json()),
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "StepTrace":
        raw = json.loads(text)
        return cls(
            name=raw["name"], arch=raw["arch"], kind=raw["kind"],
            psg=PSG.from_json(json.dumps(raw["psg"])),
            base={int(k): float(v) for k, v in raw["base"].items()},
            collectives=[CollectiveSpec.from_dict(c)
                         for c in raw["collectives"]],
            recorded_devices=int(raw.get("recorded_devices", 1)),
            mesh=dict(raw.get("mesh", {})),
            meta=dict(raw.get("meta", {})))

    def step_time(self) -> float:
        """Sum of measured top-level vertex times (seconds)."""
        tops = self.psg.children(self.psg.root)
        return sum(self.base.get(v, 0.0) for v in tops)


def list_traces(trace_dir: Optional[Path] = None) -> List[str]:
    return sorted(p.stem for p in Path(trace_dir or TRACE_DIR).glob("*.json"))


def load_trace(name: str, trace_dir: Optional[Path] = None) -> StepTrace:
    """A trace by name from ``trace_dir`` (the committed traces when
    None)."""
    path = Path(trace_dir or TRACE_DIR) / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(
            f"no trace {name!r} in {path.parent} (have: "
            f"{list_traces(trace_dir)}); record with "
            f"`python -m repro_torch.scenarios.record --out-dir DIR`")
    return StepTrace.from_json(path.read_text())


def save_trace(trace: StepTrace, trace_dir: Optional[Path] = None) -> Path:
    """Write ``trace`` as ``<name>.json`` under ``trace_dir`` (the
    committed traces' directory when None)."""
    out = Path(trace_dir or TRACE_DIR)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{trace.name}.json"
    path.write_text(trace.to_json())
    return path


def instantiate_psg(trace: StepTrace, n_procs: int,
                    anchor: Optional[int] = None) -> PSG:
    """Fresh PSG for one scenario run: copy + collectives at target scale.

    Returns a deep copy of the recorded PSG (scenarios mutate meta /
    append vertices; the cached trace must stay pristine) with one Comm
    vertex appended per recorded :class:`CollectiveSpec`, replica groups
    or ring pairs re-materialized for ``n_procs`` processes, in HLO
    program order after every recorded compute vertex — the step-end
    exposure chain a propagated delay surfaces through.  ``anchor``
    (default: the LAST measured top-level vertex — the step's compute
    tail, the true immediate dependence of a step-end collective) gets a
    data edge to every appended Comm vertex, so backtracking crosses
    from a wait symptom into the profiler PSG's real data-edge chain.
    """
    psg = PSG.from_json(trace.psg.to_json())
    if anchor is None:
        tops = [v for v in psg.children(psg.root)
                if trace.base.get(v, 0.0) > 0.0]
        anchor = tops[-1] if tops else None
    prev_comm = None
    for spec in sorted(trace.collectives, key=lambda c: c.order):
        per_bytes = spec.bytes / max(spec.count, 1)
        v = psg.new_vertex(COMM, spec.kind, parent=psg.root,
                           source=f"trace:{trace.name}")
        v.comm_kind = spec.kind.replace("-", "_")
        v.comm_bytes = float(per_bytes)
        if spec.pattern.layout == "ring":
            v.p2p_pairs = spec.pattern.pairs_at(n_procs)
        else:
            v.meta["replica_groups"] = spec.pattern.groups_at(n_procs)
        v.meta["pattern"] = dataclasses.asdict(spec.pattern)
        psg.add_edge(psg.root, v.vid, "control")
        if anchor is not None:
            psg.add_edge(anchor, v.vid, "data")
        if prev_comm is not None:
            # the step-end collectives are a dependence CHAIN: a late
            # arriver at collective k is late because of collective k-1
            # (e.g. a ring bubble), and the walk must be able to descend
            # into it rather than jump straight to compute
            psg.add_edge(prev_comm, v.vid, "data")
        prev_comm = v.vid
    return psg
