"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Loads the cell by name (``BENCHMARK.json``, ``benchmark/workloads``),
sets up, measures for ``--seconds`` seconds, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the numbers
compared with their limits (``checks``), which also close standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_lib import env  # noqa: E402
from bench_lib.cells import load_cell  # noqa: E402
from bench_lib.record import breakdown, metric_value  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", bench_path: str = None) -> int:
    """``device`` other than ``cuda`` is for the CPU tests alone: it skips
    the look for a card and reports the device it ran on."""
    args = parse(argv)
    env.set_caches()
    cell = load_cell(args.workload, bench_path)
    import torch

    if device == "cuda":
        env.require_cards(torch, cell.spec["chips"])
        card = env.card_info(torch)
    else:
        card = {"kind": device, "nvidia_smi": "none"}
    rec = cell.driver().run(cell, args, torch, device=device)
    rec.card = card["kind"]
    if args.trace:
        metrics = {}  # device numbers exist only on the card
        for m in cell.per_layer if device == "cuda" else ():
            value = cell.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": metric_value(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": metric_value(rec.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    found = env.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": card["kind"],
           "count": cell.spec["chips"], "memory_peak_bytes": int(rec.memory_peak_bytes),
           "card": card["nvidia_smi"]}
    line = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        line["breakdown"] = breakdown(rec.trace)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in rec.checks}
    passes = ("window_s", "busy_s", "host_window_s", "host_busy_s")
    print(json.dumps({"window": rec.window, "launches": rec.launches,
                      "trace_passes": rec.trace and {k: rec.trace[k] for k in passes},
                      "trace_top_ops": rec.trace and rec.trace["top_ops"]}), file=sys.stderr)
    for c in rec.checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
