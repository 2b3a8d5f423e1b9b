"""chip_smoke.py's ``beam_eval``, ``sample`` and ``naive`` phases, run on
the CPU at test size (``cruller_test`` and ``cruller_swin_test``, bf16,
batches of 2, a 300-entry tokenizer, 3 beams): their own checks pass (one
beam is greedy, the best beam's log-prob is at least greedy's, a decode
step on reordered caches equals the plain decode attention, sampling is
reproducible per seed and passes its chi-square test, the naive oracle
agrees with the cached decode) and each records its run. The launch counts
and the timings are the card's only."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch


@pytest.fixture()
def cs(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "OUT_DIR", str(tmp_path / "out"))
    return module


def _last(tmp_path):
    return json.loads((tmp_path / "out" / "phases.jsonl").read_text().splitlines()[-1])


def test_beam_eval_phase_on_the_cpu(cs, tmp_path):
    runs = (("cruller_test", "cruller_test", 300, 2, 6, "bf16"),
            ("cruller_test_int8", "cruller_test", 300, 2, 6, "int8"),
            ("swin_test", "cruller_swin_test", 300, 2, 5, "bf16"))
    counts = cs.phase_beam_eval(torch, runs=runs, K=3, device="cpu")
    assert set(counts) == {f"beam_eval_{r[0]}" for r in runs}
    assert not any(n for run in counts.values() for n in run.values())  # no kernel on the CPU
    rec = _last(tmp_path)
    assert rec["phase"] == "beam_eval" and set(rec["runs"]) == {r[0] for r in runs}
    for tag, run in rec["runs"].items():
        assert run["rows"] == 6 and run["decode_steps"] == run["new_tokens"] - 1
        assert run["reordered_step_vs_plain"]["ok"]
        assert run["reordered_step_vs_plain"]["rows_from_another_beam"] > 0
        assert run["score_dominance"]["beam_minus_greedy_min"] >= -cs.BEAM_SCORE_ATOL
        assert run.get("one_beam_equals_greedy", True)
        assert run["beam"]["pages_per_s"] > 0 and run["greedy"]["pages_per_s"] > 0


def test_sample_and_naive_phases_on_the_cpu(cs, tmp_path):
    assert set(cs.phase_sample(torch, model_name="cruller_test", B=2, new_tokens=6,
                               device="cpu")) == {"sample"}
    rec = _last(tmp_path)
    assert rec["same_seed_same_tokens"] and rec["other_seed_differs"]
    assert rec["chi2"]["p_value"] > cs.SAMPLE_P_MIN and rec["chi2"]["draws"] == 4096
    assert rec["decode_steps"] == 5
    assert set(cs.phase_naive(torch, model_name="cruller_test", B=2, new_tokens=8,
                              device="cpu")) == {"naive"}
    rec = _last(tmp_path)
    assert rec["passes"] == 8 and rec["equal_rows"] + len(rec["disagreements"]) == 2
