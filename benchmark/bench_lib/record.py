"""One run's record, which drivers fill and metric readers read, and the
result line built from it."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench_lib import compare


@dataclass
class RunRecord:
    cell: object  # bench_lib.cells.Cell
    seed: int
    setup_s: float
    memory_peak_bytes: int
    attempted: int
    failed: int
    spans: object  # bench_lib.tracing.Spans
    trace: Optional[Dict]  # bench_lib.tracing.profile(...) of the traced sub-window
    launches: Optional[Dict[str, int]]  # wrapper launch counts in the traced sub-window
    window: Dict  # what the window did: seconds, steps or batches, work counts
    e2e: Dict[str, float] = field(default_factory=dict)
    checks: List[Dict] = field(default_factory=list)
    card: str = ""  # the card's name, for its published peaks
    check_inputs: Dict = field(default_factory=dict)  # what the check ran on

    @property
    def correct(self) -> bool:
        return bool(self.checks) and compare.passed(self.checks)


def metric_value(value: float) -> float:
    if value is None or not math.isfinite(value):
        raise ValueError(f"metric value {value!r} is not a finite number")
    return float(value)


def breakdown(trace: Dict) -> Dict:
    fam = sorted(trace["family_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in fam], "idle_gaps": trace["idle"][:10]}
