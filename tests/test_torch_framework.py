"""The port's smaller framework pieces against the JAX package's: FLOP
accounting and MFU, the profiler trace context, the OCR metric utilities (exact
on the same strings), the monitor's outputs, and the train task's logging path
(rate, learning rate, train-time OCR reconstruction) on the CPU.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from pixparse_tpu.framework import profiling as jprof
from pixparse_tpu.models.config import get_model_config as jax_model_config
from pixparse_tpu.models.cruller import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.utils import ocr_eval as jocr
from pixparse_tpu.utils import text_metrics as jtm
from pixparse_tpu.utils.metrics import average_normalized_levenshtein_similarity as jax_anls
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework import profiling as tprof
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.monitor import Monitor
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils import ocr_eval as tocr
from pixparse_tpu_torch.utils import text_metrics as ttm
from pixparse_tpu_torch.utils.metrics import average_normalized_levenshtein_similarity


@pytest.mark.parametrize("name", ["cruller_base", "cruller_test"])
def test_train_flops_match_jax(name):
    jv, jb, _ = jax_resolve(jax_model_config(name))
    v, b, _ = resolve_cruller_cfgs(get_model_config(name))
    L = b.max_position_embeddings - 1
    assert tprof.cruller_train_flops(v, b, 16, L) == jprof.cruller_train_flops(jv, jb, 16, L)
    assert tprof.transformer_layer_flops(128, 64, 256, cross_Lk=77) == \
        jprof.transformer_layer_flops(128, 64, 256, cross_Lk=77)


def test_mfu_is_none_off_the_card_and_trace_writes_a_file(tmp_path):
    assert tprof.peak_flops_per_device("cpu") is None
    assert tprof.mfu(1e12, 0.1, device="cpu") is None
    with tprof.trace(None):  # no directory: a no-op
        pass
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_ocr_metric_utils_match_jax():
    preds = ["hello wrld <sep/> a p d", "the quick brown fox\njumps", "", "<pad><pad>same"]
    refs = ["hello world a p d", "the quick brown dog jumps", "empty pred", "same"]
    assert ttm.get_cer_wer_metrics({}, preds[:2], refs[:2]) == \
        jtm.get_cer_wer_metrics({}, preds[:2], refs[:2])
    assert tocr.ocr_metrics_from_text(preds, refs) == jocr.ocr_metrics_from_text(preds, refs)
    assert tocr.ocr_metrics_from_text([""], [""]) == (None, None)
    ids = np.array([[5, 6, -100, -100], [7, -100, -100, -100]])
    np.testing.assert_array_equal(tocr.restore_ignored(ids, 1), jocr.restore_ignored(ids, 1))
    assert tocr.max_target_length(tocr.restore_ignored(ids, 1), 1, 256) == \
        jocr.max_target_length(jocr.restore_ignored(ids, 1), 1, 256) == 64
    answers, preds = [["forty two", "42"], ["x"]], ["forty-two", "y"]
    assert average_normalized_levenshtein_similarity(answers, preds) == jax_anls(answers, preds)


def test_monitor_writes_log_lines_and_the_summary_csv(tmp_path, caplog):
    monitor = Monitor("exp", output_dir=str(tmp_path))
    with caplog.at_level(logging.INFO):
        monitor.log_step("train", step_idx=3, step_end_idx=10, interval=0, loss=1.5, rate=12.0,
                         lr=1e-4, metrics={"mfu": 0.1})
        monitor.log_phase("train", interval=0)
    monitor.write_summary({"train": {"step": 3, "loss": 1.5}}, index=0)
    monitor.write_summary({"train": {"step": 6, "loss": 1.2}}, index=1)
    monitor.close()
    assert any("loss: 1.50000" in r.getMessage() for r in caplog.records)
    with open(tmp_path / "summary.csv") as fh:
        rows = fh.read().strip().splitlines()
    assert rows[0].split(",")[:3] == ["interval", "train_step", "train_loss"] and len(rows) == 3
    silent = Monitor("exp", output_dir=str(tmp_path / "off"), output_enabled=False)
    silent.write_summary({"train": {"step": 1}}, index=0)
    assert not os.path.exists(tmp_path / "off" / "summary.csv")


class _RecordingMonitor:
    def __init__(self):
        self.steps = []

    def log_step(self, phase, **kwargs):
        self.steps.append((phase, kwargs))

    def log_phase(self, *args, **kwargs):
        pass

    def write_summary(self, *args, **kwargs):
        pass


def test_train_task_logs_rate_lr_and_ocr_reconstruction(caplog, monkeypatch):
    from pixparse_tpu_torch.task import cruller_base

    decodes = []
    real_generate = cruller_base.generate

    def spy(model, enc, prompt, **kwargs):
        result = real_generate(model, enc, prompt, **kwargs)
        decodes.append((model.training, tuple(result.tokens.shape), kwargs["max_length"]))
        return result

    monkeypatch.setattr(cruller_base, "generate", spy)
    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        opt=OptimizationCfg(learning_rate=1e-3), num_intervals=1, num_warmup_intervals=0,
        dtype="float32", device="cpu", eval_frequency=2,
    )
    monitor = _RecordingMonitor()
    task = TaskCrullerPretrain(cfg, DeviceEnv.initialize("cpu"), monitor)
    task.log_frequency = 1
    task.train_setup(num_batches_per_interval=4, seed=0)
    rng = np.random.RandomState(0)
    image = rng.randn(3, 64, 48, 1).astype(np.float32)
    anno = {"pages": [{"text": ["some words to read"]}]}
    rows = [task.anno_preprocess_train(anno)[0] for _ in range(3)]
    text = np.stack([r["text"][0] for r in rows])
    target = np.stack([r["target"][0] for r in rows])
    task.train_interval_start()
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            out = task.train_step((image, text, target))
    assert not [r for r in caplog.records if "reconstruction failed" in r.getMessage()]
    assert torch.is_tensor(out["loss"]) and task.step_idx == 2 and task.state.step == 2
    plain = [kw for _, kw in monitor.steps if not kw.get("phase_suffix")]
    recon = [kw for _, kw in monitor.steps if kw.get("phase_suffix") == "ocr_reconstruction"]
    assert len(plain) == 2 and np.isfinite(plain[0]["loss"]) and plain[0]["rate"] > 0
    assert plain[1]["lr"] == pytest.approx(task.get_current_lr())
    # eval_frequency = 2: one greedy decode of the batch, in eval mode, capped at
    # the reference's length rounded up to a multiple of 64
    assert decodes == [(False, (3, 64), 64)]
    # random weights may decode to nothing but tags; when text comes out it is scored
    for kw in recon:
        assert {"cer", "wer"} <= set(kw["metrics"])
        assert kw["eval_data"]["original_text"].startswith("some words")
    assert task.model.training  # generation left the model in training mode
    # shifted in the step: inputs drop the last token, targets the first
    batch = task.normalize_batch((image, text, target))
    assert batch["text"].shape == (3, 127) and batch["target"].shape == (3, 127)
    np.testing.assert_array_equal(batch["text"], text[:, :-1])
    np.testing.assert_array_equal(batch["target"], target[:, 1:])
