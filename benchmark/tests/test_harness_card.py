"""On the card: one short run of each cell as the benchmark makes it, correct
and with the contract's line (``python -m pytest benchmark/tests -m cuda``)."""

import json
import os
import subprocess
import sys

import pytest

from checkout import REPO, load


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in load(os.path.join(REPO, "BENCHMARK.json"))["workloads"]])
def test_cell_on_the_card(cuda_card, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "4294967311", "--seconds", "3", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["kind"] == cuda_card
