"""The port's program spans and counters (``framework/profiling.py``): off
by default and then one shared no-op; when collected, nested spans carry
their parent and self times; the train step, the eval encoder's copy,
greedy ``generate`` and ``batch_decode`` report the spans and counters
their readers expect, and give the same results with collection on and
off; under ``torch.profiler`` each span is a ``pixparse.<name>`` range."""

import logging
import time

import numpy as np
import pytest
import torch

from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework import profiling
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.profiling import collect, count, span
from pixparse_tpu_torch.ops.generation import generate
from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer, TokenizerCfg

TOKENIZER = TokenizerCfg(name="pixparse_bytelevel")
SETUP = ("setup.task", "setup.model", "setup.to_device")


def test_off_a_span_is_one_shared_noop_and_nothing_is_recorded():
    first, second = span("a"), span("b")
    assert first is second
    with first:
        count("n", 5)
    with collect() as c:
        with span("inside"):
            count("n")
    assert span("after") is first
    assert [r.name for r in c.spans] == ["inside"] and c.counts == {"n": 1}


def test_nested_spans_carry_their_parent_and_self_time():
    with collect() as c:
        with span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with span("inner"):
                    time.sleep(0.001)
    inner = [r for r in c.spans if r.name == "inner"]
    (outer,) = [r for r in c.spans if r.name == "outer"]
    assert [r.parent for r in inner] == ["outer", "outer"] and outer.parent is None
    assert all(r.start <= r.end for r in c.spans)
    assert outer.start <= inner[0].start and inner[1].end <= outer.end
    t = c.totals()
    assert t["inner"]["count"] == 2 and t["outer"]["count"] == 1
    assert t["inner"]["self_s"] == pytest.approx(t["inner"]["total_s"])
    children = sum(r.seconds for r in inner)
    assert t["outer"]["self_s"] == pytest.approx(t["outer"]["total_s"] - children)
    assert t["outer"]["self_s"] >= 0.002


def test_collection_is_off_after_an_exception():
    with pytest.raises(RuntimeError):
        with collect() as c:
            with span("failing"):
                raise RuntimeError("inside")
    assert [r.name for r in c.spans] == ["failing"]
    assert span("after") is span("again")


def test_train_step_spans_once_a_step_and_counts_the_batch_bytes():
    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TOKENIZER, opt=OptimizationCfg(learning_rate=1e-3),
        num_intervals=1, num_warmup_intervals=0, dtype="float32", device="cpu")
    task = TaskCrullerPretrain(cfg, DeviceEnv.initialize("cpu"))
    with collect() as setup:
        task.train_setup(num_batches_per_interval=4, seed=0)
    t = setup.totals()
    assert all(t[n]["count"] == 1 for n in SETUP + ("setup.train_state",))
    assert {r.parent for r in setup.spans if r.name != "setup.task"} == {"setup.task"}
    rng = np.random.RandomState(0)
    sample = {"image": rng.randn(2, 64, 48, 1).astype(np.float32),
              "text": rng.randint(4, 200, size=(2, 17)),
              "target": rng.randint(4, 200, size=(2, 17))}
    with collect() as c:
        for _ in range(2):
            task.train_step(sample)
    t = c.totals()
    names = ("train.prepare", "train.to_device", "train.forward_backward", "train.optimizer")
    assert set(t) == set(names) and all(t[n]["count"] == 2 for n in names)
    batch = task.normalize_batch(sample)
    assert c.counts == {"h2d_bytes": 2 * sum(v.nbytes for v in batch.values())}


@pytest.fixture(scope="module")
def eval_task():
    cfg = TaskCrullerEvalOCRCfg(model_name="cruller_test", tokenizer=TOKENIZER, dtype="float32",
                                device="cpu")
    task = TaskCrullerEvalOCR(cfg, DeviceEnv.initialize("cpu"))
    with collect() as c:
        task.setup()
    task.setup_spans = c.totals()
    return task


def test_eval_setup_and_encode_spans(eval_task):
    assert all(eval_task.setup_spans[n]["count"] == 1 for n in SETUP)
    images = np.random.RandomState(1).randn(2, 64, 48, 1)  # float64: the copy is float32
    with collect() as c:
        enc = eval_task.encode_images(images)
    assert c.totals()["eval.to_device"]["count"] == 1
    assert c.counts == {"h2d_bytes": images.size * 4}
    torch.testing.assert_close(enc, eval_task.encode_images(images), rtol=0, atol=0)


def test_greedy_generate_counts_a_flag_read_a_step_and_keeps_its_tokens(eval_task):
    rng = np.random.RandomState(2)
    enc = eval_task.encode_images(rng.randn(3, 64, 48, 1).astype(np.float32))
    prompts = torch.as_tensor(eval_task.prompt_ids(eval_task.task_start_token, 3))
    kwargs = dict(max_length=prompts.shape[1] + 6, eos_token_id=-1,
                  pad_token_id=eval_task.tokenizer.pad_token_id)
    off = generate(eval_task.model, enc, prompts, **kwargs)
    with collect() as c:
        on = generate(eval_task.model, enc, prompts, **kwargs)
    assert on.steps == off.steps == 5
    torch.testing.assert_close(on.tokens, off.tokens, rtol=0, atol=0)
    t = c.totals()
    assert t["generate.prefill"]["count"] == 1
    assert t["generate.step"]["count"] == t["generate.sync"]["count"] == on.steps
    assert c.counts == {"host_reads": on.steps}
    assert {r.parent for r in c.spans if r.name == "generate.sync"} == {"generate.step"}
    # the step's self time leaves the flag read out
    step = t["generate.step"]
    assert step["self_s"] == pytest.approx(step["total_s"] - t["generate.sync"]["total_s"])


def test_batch_decode_strings_are_the_same_with_collection_on():
    tok = ByteLevelTokenizer()
    seqs = [tok.encode("héllo <s> wörld"), [0, 5, 300, 2, 1, 1], []]
    off = tok.batch_decode(seqs, skip_special_tokens=True)
    with collect() as c:
        on = tok.batch_decode(seqs, skip_special_tokens=True)
    assert on == off and c.totals()["tokenizer.batch_decode"]["count"] == 1


def test_spans_are_profiler_ranges_and_trace_logs_them(tmp_path, caplog):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, collect():
        with span("outer"):
            with span("inner"):
                torch.ones(4) + 1
    names = {e.name for e in prof.events()}
    assert {"pixparse.outer", "pixparse.inner"} <= names
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        with profiling.trace(str(tmp_path)) as spans:
            with span("work"):
                count("items", 3)
    assert spans.totals()["work"]["count"] == 1
    line = [r.getMessage() for r in caplog.records if "spans (calls" in r.getMessage()]
    assert len(line) == 1 and "work 1 x " in line[0] and "items 3" in line[0]
    assert span("off") is span("again")
