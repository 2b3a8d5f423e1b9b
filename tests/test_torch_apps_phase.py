"""``chip_smoke.py``'s ``apps`` phase rehearsed on the CPU at cruller_test:
``app.train`` from a tar shard for two intervals, its resume-latest into a
third, ``app.eval`` from the last ``.pt`` over the shard, the same from a
stand-in S3 (the ``.pt`` fetched by key), and ``app.infer``
over the same pages as files (batched in a child process, continuous in
this one). Once with the native library hidden, so PIL decodes the shard,
and once with it where it builds here. The phase holds its own gates and
raises when one fails; these tests read its record."""

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RUNS = ("apps_train", "apps_resume", "apps_eval", "apps_s3_eval", "apps_infer_batched",
        "apps_infer_continuous")
PAGES = 6  # 2 PNG pages and the 4 JPEG fixtures once


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["PIL", "native"])
def apps(request, tmp_path_factory):
    """The phase once per decoder: B=2, 2 steps an interval, infer at B=4
    (so its last batch is padded), 8 new tokens."""
    from pixparse_tpu_torch import native

    cs = _chip_smoke()
    out = tmp_path_factory.mktemp(f"apps_{request.param}")
    patch = pytest.MonkeyPatch()
    patch.setattr(cs, "OUT_DIR", str(out))
    if request.param == "PIL":
        patch.setattr(native, "load_native", lambda: None)
    elif native.load_native() is None:
        pytest.skip(f"the native library does not build here: {native.build_error()}")
    before = sys.modules.get("boto3", "absent")
    try:
        with cs.nan_default_init(torch):
            counts = cs.phase_apps(torch, model_name="cruller_test", B=2, steps=2, intervals=2,
                                   page_size=(220, 170), n_png=2, jpeg_repeats=1, workers=2,
                                   infer_B=4, new_tokens=8, vocab=300, device="cpu")
    finally:
        patch.undo()
    rec = json.loads((out / "phases.jsonl").read_text().splitlines()[-1])
    return request.param, counts, rec, sys.modules.get("boto3", "absent") is before


def test_chip_smoke_apps_phase_on_the_cpu(apps):
    decoder, counts, rec, boto3_restored = apps
    assert set(counts) == set(RUNS)
    assert rec["phase"] == "apps" and rec["shard"]["pages"] == PAGES
    assert rec["decoders"]["shard"] == decoder and rec["decoders"]["infer"] == "PIL"
    by_rule, other = ("native", "other") if decoder == "native" else ("other", "native")
    for run in ("train", "resume", "eval", "s3_eval"):
        decoded = rec[run]["pages_decoded"]
        assert decoded[by_rule] > 0 and decoded[other] == 0, (run, decoded)

    train, resume = rec["train"], rec["resume"]
    assert train["rc"] == 0 and train["steps"] == 4 and len(train["save_s"]) == 2
    assert train["workers"] == resume["workers"] == 2 and len(train["in_memory_step_ms"]) == 2
    assert set(train["written"]) == {f"checkpoint-{i}{tail}" for i in (0, 1) for tail in
                                     (".pt", "/state.pt", "/metadata.json")}
    assert all(train["written"].values())
    assert train["step1_vs_arrays"]["rel_diff"] <= 1e-3
    assert all(math.isfinite(x) for x in train["losses"])

    assert resume["rc"] == 0 and resume["steps"] == 2
    assert resume["path"] == "checkpoint-1" and resume["start_interval"] == 2
    assert resume["state_step"] == resume["metadata"]["step"] == 4
    assert resume["final_metadata"] == {"interval": 2, "step": 6}
    assert resume["tensors"] > 0
    assert resume["bit_equal"] == resume["on_device"] == resume["tensors"]

    ev = rec["eval"]
    assert ev["rc"] == 0 and ev["pages"] == PAGES
    assert ev["metrics_file"].endswith("checkpoint-2-apps-metrics.json")
    assert all(math.isfinite(ev["metrics"]["eval"]["average"][k]) for k in ("cer", "wer"))
    assert ev["weights"]["dtype"] == "torch.bfloat16"
    assert ev["weights"]["bit_equal"] == ev["weights"]["tensors"] > 0
    s3 = rec["s3_eval"]
    assert s3["rc"] == 0 and s3["pages"] == PAGES and s3["bucket"] == "chip-smoke"
    assert s3["downloads"] == [{"bucket": "chip-smoke", "key": s3["key"]}]
    assert s3["key"].endswith("checkpoint-2.pt")
    assert s3["metrics_file"] == s3["key"].replace("/", "_").replace(".pt", "") + "-apps-metrics.json"
    assert s3["metrics"] == ev["metrics"] and s3["metrics_equal_to_eval"]
    assert s3["weights"]["bit_equal"] == s3["weights"]["tensors"] == ev["weights"]["tensors"]
    assert s3["eval_pages_per_s"] == ev["pages_per_s"] and s3["pages_per_s"] > 0
    assert boto3_restored  # the stand-in was in sys.modules only while (f) ran

    batched, continuous = rec["infer"]["batched"], rec["infer"]["continuous"]
    assert batched["rc"] == 0 and continuous["rc"] == 0
    assert batched["lines"] == continuous["lines"] == PAGES
    assert batched["in_input_order"] and continuous["in_input_order"]
    assert batched["equal_to_generate_text"] == PAGES
    assert batched["opened"] == 8  # the last batch of 4 padded with its last page
    assert len(batched["generate_s"]) == 2 and continuous["generate_s"] == []
    assert continuous["opened"] == PAGES
    assert 0.0 <= continuous["equal_to_batched_share"] <= 1.0
