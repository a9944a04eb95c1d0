"""Everything of a cell is found by name, each in a file of its own:

- ``BENCHMARK.json`` at the checkout root: the cells and the metrics;
- ``chipbench/configs/<config>.json``: a configuration (its ``file``);
- ``chipbench/traffic/<traffic>.json``: a traffic mix, whose ``kind``
  names the runner ``chipbench/kinds/<kind>.py``;
- ``chipbench/metrics/<metric>.py``: a metric's reader, ``read(run)``;
- ``chipbench/kernel_classes/<class>/*.txt``: one kernel-name pattern a
  file (a regular expression, matched anywhere, case-insensitive);
- ``chipbench/limits/<workload>.json``: the limits that decide
  ``correct`` in a cell;
- ``chipbench/peaks.json``: the table of peaks by device name.

A later cell adds files and entries; no file here needs an edit."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # chipbench/
ROOT = HERE.parent                                   # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = _json(ROOT / c["file"])
            if cfg.get("name") != name:
                raise ValueError(f"{c['file']} names {cfg.get('name')!r}")
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{_name('traffic', name)}.json")


def limits(workload_name: str) -> Dict[str, float]:
    return _json(HERE / "limits" / f"{_name('workload', workload_name)}.json")


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The row of the peak table whose key the device name contains."""
    for key, row in _json(HERE / "peaks.json")["devices"].items():
        if key in device_name:
            return row
    return None


def kind(name: str):
    return importlib.import_module(f"chipbench.kinds.{_name('kind', name)}")


def metric_reader(name: str):
    return importlib.import_module(
        f"chipbench.metrics.{_name('metric', name).replace('.', '__')}")


def kernel_class(name: str) -> List[re.Pattern]:
    d = HERE / "kernel_classes" / _name("kernel class", name)
    pats = [p.read_text().strip() for p in sorted(d.glob("*.txt"))]
    return [re.compile(p, re.IGNORECASE) for p in pats if p]


def metrics_for(bench: Dict, workload_name: str, group: str) -> List[Dict]:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that a cell
    reports: those listing it, or listing no cells (a per-layer metric
    then goes where the end-to-end metric it moves is reported)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload_name in m["workloads"]]
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out
