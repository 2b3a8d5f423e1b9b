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


def test_pix2struct_phase_on_the_cpu(cs, tmp_path):
    """The pix2struct phase at ``pix2struct_test`` (64 patches), a batch of 4
    pages of four sizes patchified by the device path, a 300-entry tokenizer:
    its own gates pass (losses finite and falling, step-1 kernel vs plain,
    padding rows 0, encoder token by token, cached decode with the pad mask)
    and it records both encoders against the fp32 forward."""
    pages = ((60, 240), (100, 220), (140, 200), (260, 140))  # 64, 55, 54, 50 patches
    counts = cs.phase_pix2struct(torch, model_name="pix2struct_test", B=4, steps=3, new_tokens=6,
                                 pages=pages, vocab=300, device="cpu")
    assert set(counts) == {"pix2struct_train", "pix2struct_serve"}
    assert not any(n for run in counts.values() for n in run.values())  # no kernel on the CPU
    rec = _last(tmp_path)
    assert rec["phase"] == "pix2struct" and len(set(rec["kv_lens"])) == 4
    assert rec["kv_lens"] == cs.pix2struct_lens(64, 16, pages, 4)
    train, serve = rec["train"], rec["serve"]
    assert train["remat"] is False and len(train["losses"]) == 3
    assert train["step1_kernel_vs_plain_b2"]["leaves"] > 0
    assert serve["padding_rows_zero"] and serve["decode_steps"] == 5
    fp32 = serve["encode_vs_fp32"]
    assert set(fp32) >= {"kernel", "plain"}
    assert fp32["kernel"]["dead_tokens_nonzero"] == 0
    assert fp32["kernel"]["worst_token_rel_err"] < 5e-2


def test_encoder_vs_fp32_measures_both_bf16_paths(cs):
    """``large``'s and ``pix2struct``'s fp32 reference: a bf16 ViT encoder's
    two outputs against an fp32 plain forward of the same weights; an exact
    copy of the reference scores 0."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs

    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=300)
    model = Cruller(v, b).init_weights(torch.Generator().manual_seed(0)).to(torch.bfloat16).eval()
    images = cs.synthetic_pages(torch, 2, *v.img_size, torch.Generator().manual_seed(1))
    with torch.inference_mode():
        enc = model.encode(images)
        exact = model.float().encode(images.float())
    model.to(torch.bfloat16)
    out = cs.encoder_vs_fp32(torch, model, images, {"bf16": enc, "fp32": exact})
    assert out["fp32"]["max_abs_err"] == 0.0 and out["fp32"]["worst_token_rel_err"] == 0.0
    assert 0 < out["bf16"]["mean_token_rel_err"] <= out["bf16"]["worst_token_rel_err"] < 5e-2
    assert out["bf16_over_fp32_worst"] is None  # no ratio over a zero error
