"""``nvidia-smi`` sampled beside the window: clocks, power draw, power
limit and temperature every half second, from a process started before
the window and stopped (and waited for) after it."""
from __future__ import annotations

import shutil
import statistics
import subprocess
from typing import Dict, Optional

FIELDS = ("index", "name", "clocks.sm", "clocks.mem", "power.draw",
          "power.limit", "temperature.gpu")


class Smi:
    def __init__(self, interval_ms: int = 500):
        self.interval_ms = interval_ms
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        if shutil.which("nvidia-smi") is None:
            return
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", str(self.interval_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> Optional[Dict]:
        """Ends the sampler; the samples' summary by card (median, min and
        max of each number), or None without ``nvidia-smi``."""
        if self.proc is None:
            return None
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.proc = None
        cards: Dict[str, Dict] = {}
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(FIELDS):
                continue
            card = cards.setdefault(parts[0], {"name": parts[1], "rows": []})
            try:
                card["rows"].append([float(x) for x in parts[2:]])
            except ValueError:
                continue
        summary = {}
        for idx, card in cards.items():
            rows = card["rows"]
            if not rows:
                continue
            cols = list(zip(*rows))
            s = {"name": card["name"], "samples": len(rows)}
            for field, col in zip(FIELDS[2:], cols):
                s[field] = [statistics.median(col), min(col), max(col)]
            summary[idx] = s
        return summary
