"""The port's ``ThreadLocalTokenizer`` and its use by the Cruller tasks.

An HF fast tokenizer (built offline by the JAX package's
``create_bytelevel_tokenizer``) is called from four threads at once with
different ``max_length`` and padding: through the wrapper, no thread raises
and every thread's ids equal the bare tokenizer's, called alone. The tasks
wrap every tokenizer but the port's byte-level one.
"""

import copy
import threading

import numpy as np
import pytest

from pixparse_tpu.tokenizers.local_bpe import create_bytelevel_tokenizer
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.task.common import SPECIAL_TOKENS_FROM_PRETRAIN, add_special_tokens
from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer, TokenizerCfg
from pixparse_tpu_torch.tokenizers.thread_safe import ThreadLocalTokenizer

TEXTS = ["hello world", "the quick brown fox jumps", "<s_pretrain>naïve café", "x" * 200, ""]
SETTINGS = [  # (max_length, padding) per thread
    (16, "max_length"), (64, "longest"), (32, "max_length"), (128, False),
]
CALLS = 300


def _hf():
    tok = create_bytelevel_tokenizer()
    add_special_tokens(tok, SPECIAL_TOKENS_FROM_PRETRAIN)
    return tok


def _ids(tok, max_length, padding):
    out = tok(TEXTS, add_special_tokens=False, max_length=max_length, padding=padding,
              truncation=True)
    return [list(r) for r in out["input_ids"]]


def test_threads_with_mixed_settings_get_the_bare_tokenizers_ids():
    bare = _hf()
    want = {s: _ids(bare, *s) for s in SETTINGS}
    wrapped = ThreadLocalTokenizer(_hf())
    errors, results = [], {}
    start = threading.Barrier(len(SETTINGS))

    def work(setting):
        try:
            start.wait()
            for _ in range(CALLS):
                got = _ids(wrapped, *setting)
            results[setting] = got
        except Exception as e:  # any exception fails the test below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(s,)) for s in SETTINGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert results == want


def test_each_thread_holds_its_own_copy():
    base = _hf()
    wrapped = ThreadLocalTokenizer(base)
    seen = {}

    def work(i):
        seen[i] = (wrapped._get(), wrapped._get())

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(a is b for a, b in seen.values())  # one copy per thread, kept
    copies = [a for a, _ in seen.values()] + [wrapped._get()]
    assert len({id(c) for c in copies}) == 4 and all(c is not base for c in copies)


def test_the_wrapper_delegates_and_copies_to_a_plain_tokenizer():
    base = _hf()
    wrapped = ThreadLocalTokenizer(base)
    assert len(wrapped) == len(base)
    assert wrapped.pad_token_id == base.pad_token_id and wrapped.eos_token == base.eos_token
    assert wrapped.convert_tokens_to_ids("<s_pretrain>") == base.convert_tokens_to_ids(
        "<s_pretrain>")
    assert wrapped.batch_decode([[40, 41]]) == base.batch_decode([[40, 41]])
    plain = copy.deepcopy(wrapped)
    assert type(plain) is type(base) and len(plain) == len(base)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hf_tokenizer"))
    create_bytelevel_tokenizer().save_pretrained(path)
    return path


@pytest.mark.parametrize("task_cls,cfg_cls", [
    (TaskCrullerPretrain, TaskCrullerPretrainCfg), (TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg),
])
def test_tasks_wrap_an_hf_tokenizer_and_leave_the_bytelevel_one_bare(hf_dir, task_cls, cfg_cls):
    env = DeviceEnv.initialize("cpu")
    hf = task_cls(cfg_cls(model_name="cruller_test", tokenizer=TokenizerCfg(name=hf_dir),
                          device="cpu"), env)
    bl = task_cls(cfg_cls(model_name="cruller_test",
                          tokenizer=TokenizerCfg(name="pixparse_bytelevel"), device="cpu"), env)
    assert isinstance(hf.tokenizer, ThreadLocalTokenizer)
    assert type(bl.tokenizer) is ByteLevelTokenizer
    # the replay happened before the wrap: sizes and ids as the bare tokenizer's
    bare = _hf()
    assert hf.vocab_size == len(hf.tokenizer) == len(bare) == bl.vocab_size
    for tok in SPECIAL_TOKENS_FROM_PRETRAIN:
        assert hf.tokenizer.convert_tokens_to_ids(tok) == bare.convert_tokens_to_ids(tok)
    kw = dict(add_special_tokens=False, max_length=16, padding="max_length", truncation=True,
              return_tensors="np")
    for text in TEXTS:
        np.testing.assert_array_equal(hf.tokenizer(text, **kw).input_ids,
                                      bl.tokenizer(text, **kw).input_ids)
