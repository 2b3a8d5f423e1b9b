"""The numbers that decide ``correct``, each held against its limit (the
cell file's ``check.limits``).

Training (a step the window's own call ran, against the reference's):

- ``loss_gap``: the largest relative gap of the first steps' losses;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's worked out from its Adam state after one step),
  over the larger of that leaf's and the median leaf's reference norm;
- ``delta_gap``: the same for the parameters' change after the first
  steps, over leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf with a gradient nought to rounding, such as a
  key bias under softmax, moves by round-off alone).

Serving (pages the window finished, drawn from the seed):

- ``enc_gap``: the worst page's relative L2 gap of the encoder rows;
- ``served_gap``: the widest gap, in logits, by which a served token lies
  below the reference's best at its position (0 where the reference puts
  it first).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> float:
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        scale = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / scale if scale > 0 else abs(prog[n] - ref[n])
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    names = list(ref["grad_norms"])
    if set(names) != set(prog["grad_norms"]):
        raise ValueError("the program's leaves differ from the reference's")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad_norms"].values())
    moving = [n for n in names if ref["grad_norms"][n] >= GRAD_FLOOR * med]
    return {
        "loss_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
        "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], names),
        "delta_gap": _leaf_gap(prog["delta_norms"], ref["delta_norms"], moving),
    }


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """``[{name, value, limit}]`` in the limits' order; a number the run
    could not read is infinite."""
    return [{"name": k, "value": float(numbers.get(k, math.inf)), "limit": float(v)}
            for k, v in limits.items()]


def passed(rows: List[Dict]) -> bool:
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows)
