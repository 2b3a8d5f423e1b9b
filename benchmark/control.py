"""Readings from which a cell's limits are set; the benchmark's own runs
never run this.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... --control-seeds 3 \
        --seconds <s> [--out <dir>]

For each seed, one run of the cell as ``run.py`` makes it with a short
window (``--seconds``: long enough for the pool's first pass, so that the
check compares as many pages as a full run does), giving the program's
numbers against the reference; on the first ``--control-seeds`` seeds also
the control's numbers: the reference computed in fp8 (e4m3, one scale a
tensor) in the program's place, on the same inputs. One JSON line per seed
on standard output and in ``<out>/<cell>.jsonl``. ``--fault <name>`` plants
one of ``tests/faults.py``'s faults first: the readings are then the
fault's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_lib import env  # noqa: E402
from bench_lib.cells import load_cell  # noqa: E402


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=os.path.join(env.CACHE_DIR, "control"))
    ap.add_argument("--fault", help="a function of tests/faults.py planted before the runs: "
                    "the fault's readings instead of the program's")
    args = ap.parse_args(argv)
    env.set_caches()
    if args.fault:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
        import faults

        getattr(faults, args.fault)()
    cell = load_cell(args.workload)
    import torch

    if device == "cuda":
        env.require_cards(torch, cell.spec["chips"])
        card = env.card_info(torch)["nvidia_smi"]
    else:
        card = device
    driver = cell.driver()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.jsonl")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run_args = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        rec = driver.run(cell, run_args, torch, device=device)
        line = {"workload": args.workload, "seed": seed, "card": card, "fault": args.fault,
                "program": rec.check_inputs["numbers"],
                "e2e": rec.e2e, "window": rec.window}
        if i < args.control_seeds:
            line["control"] = driver.control_numbers(torch, cell, rec, device=device)
        line["seconds"] = time.perf_counter() - t0
        del rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        with open(path, "a") as fh:
            fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
