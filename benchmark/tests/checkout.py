"""A scratch checkout for the CPU tests: a copy of ``benchmark/`` with the
test-size configurations and cells of ``tests/data`` added as files, and a
``BENCHMARK.json`` that lists them beside the real entries' metrics. Runs
of it go through ``run.main`` in a child process on the CPU (the look for a
card skipped), with the repository's root on the path for the program."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
DATA = os.path.join(HERE, "data")


def load(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def make(root: str, cells: Optional[List[str]] = None) -> str:
    """Copy the benchmark into ``root`` with the test cells; returns ``root``."""
    dst = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    for kind in ("configs", "workloads"):
        for name in os.listdir(os.path.join(DATA, kind)):
            shutil.copy(os.path.join(DATA, kind, name), os.path.join(dst, kind, name))
    bench = copy.deepcopy(load(os.path.join(REPO, "BENCHMARK.json")))
    names = cells or sorted(n[:-5] for n in os.listdir(os.path.join(DATA, "workloads")))
    for name in os.listdir(os.path.join(DATA, "configs")):
        cfg = load(os.path.join(DATA, "configs", name))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "reduced": [],
                                 "file": f"benchmark/configs/{name}", "why": "test size"})
    for name in names:
        spec = load(os.path.join(DATA, "workloads", f"{name}.json"))
        bench["workloads"].append({"name": name, "config": spec["config"],
                                   "traffic": spec["traffic"], "chips": 1, "why": "test"})
        train = spec["driver"] == "train"
        for m in bench["end_to_end"] + bench["per_layer"]:
            listed = m.get("workloads")
            if listed is not None and any(w.endswith(".pretrain") == train for w in listed):
                listed.append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=2)
    return root


def run(root: str, workload: str, seed: int = 7, seconds: float = 1.0, trace: int = 0,
        fault: Optional[str] = None, timeout: float = 600) -> subprocess.CompletedProcess:
    """One run of ``workload`` from ``root`` on the CPU; ``fault``: a
    ``tests/faults.py`` function that breaks the timed path first."""
    code = (
        "import sys; sys.path.insert(0, {bench!r}); sys.path.insert(0, {tests!r})\n"
        "import run\n"
        "{fault}"
        "sys.exit(run.main({argv!r}, device='cpu'))\n"
    ).format(bench=os.path.join(root, "benchmark"), tests=HERE,
             fault=f"import faults; faults.{fault}()\n" if fault else "",
             argv=["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def run_control(root: str, workload: str, seeds: str, out: str,
                timeout: float = 600) -> subprocess.CompletedProcess:
    """``control.py`` for ``workload`` from ``root`` on the CPU."""
    argv = ["--workload", workload, "--seeds", seeds, "--control-seeds", "99",
            "--seconds", "0.3", "--out", out]
    code = ("import sys; sys.path.insert(0, {bench!r}); import control\n"
            "sys.exit(control.main({argv!r}, device='cpu'))\n").format(
        bench=os.path.join(root, "benchmark"), argv=argv)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def last_line(proc: subprocess.CompletedProcess) -> Dict:
    lines = [x for x in proc.stdout.strip().splitlines() if x.strip()]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"rc {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])
