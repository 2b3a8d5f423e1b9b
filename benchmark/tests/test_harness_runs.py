"""Each driver end to end on the CPU at the test sizes, a cell added by
files alone, the faults a cell can have, and the control at a tiny size."""

import os

import pytest

import checkout

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout.make(str(tmp_path_factory.mktemp("checkout")))


CELLS = ["cruller_test.pretrain", "cruller_swin_test.pretrain", "cruller_test.ocr_eval",
         "cruller_swin_test.docvqa_eval"]


@pytest.mark.parametrize("cell", CELLS)
def test_driver_runs_and_prints_the_contract_line(root, cell):
    proc = checkout.run(root, cell, seed=2**31 + 5)
    line = checkout.last_line(proc)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"setup_s", "peak_memory_gib"} <= set(line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared close standard error, each beside its limit
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_traced_run_prints_breakdown_and_window(root):
    line = checkout.last_line(checkout.run(root, "cruller_test.ocr_eval", seed=3, trace=1))
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert line["metrics"] == {}  # device metrics are never read off the card


def test_same_seed_same_inputs_and_result(root):
    a = checkout.last_line(checkout.run(root, "cruller_test.pretrain", seed=11))
    b = checkout.last_line(checkout.run(root, "cruller_test.pretrain", seed=11))
    assert a["checks"] == b["checks"]


def test_a_new_cell_runs_from_files_alone(tmp_path):
    """Adding a cell adds its file and a BENCHMARK.json entry; no file of the
    benchmark is edited (the checkout copies them byte for byte)."""
    root = checkout.make(str(tmp_path), cells=["cruller_swin_test.ocr_eval"])
    for dirpath, _, files in os.walk(checkout.BENCH):
        if ".cache" in dirpath or "__pycache__" in dirpath or "/tests" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), checkout.BENCH)
            with open(os.path.join(dirpath, f), "rb") as a, \
                    open(os.path.join(root, "benchmark", rel), "rb") as b:
                assert a.read() == b.read(), rel
    assert checkout.last_line(checkout.run(root, "cruller_swin_test.ocr_eval"))["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("cruller_test.pretrain", "state_unchanged"),
    ("cruller_test.pretrain", "half_batch"),
    ("cruller_swin_test.pretrain", "state_unchanged"),
    ("cruller_swin_test.pretrain", "half_batch"),
    ("cruller_test.ocr_eval", "token_altered"),
    ("cruller_swin_test.docvqa_eval", "token_altered"),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    line = checkout.last_line(checkout.run(root, cell, fault=fault))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["cruller_test.pretrain", "cruller_swin_test.pretrain",
                                  "cruller_test.ocr_eval", "cruller_swin_test.docvqa_eval"])
def test_the_control_fails_where_the_program_passes(root, cell):
    """The reference in fp8 in the program's place fails at least one of the
    cell's limits on every seed, while the program passes them."""
    import json

    out = os.path.join(root, "control-out")
    proc = checkout.run_control(root, cell, seeds="21,22,23", out=out)
    assert proc.returncode == 0, proc.stderr[-3000:]
    spec = checkout.load(os.path.join(checkout.DATA, "workloads", f"{cell}.json"))
    limits = spec["check"]["limits"]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert all(line["program"][k] <= v for k, v in limits.items()), line
        assert any(line["control"][k] > v for k, v in limits.items()), line
