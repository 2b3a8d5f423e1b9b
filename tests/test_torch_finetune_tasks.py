"""The port's finetune tasks (and the vocabulary of its eval tasks) against
the JAX package's, on the CPU at ``cruller_test`` (fp32, ``device="cpu"``):

- the CORD, DocVQA (the same ``np.random.seed``) and RVL-CDIP collates give
  the JAX tasks' token arrays exactly, and their images within 1e-6 (the
  legacy transform's bound in ``tests/test_torch_data.py``);
- ``vocab_size``, ``vocab_size_base``, ``newly_added_num`` and the id of
  every finetune token equal the JAX task's, for all seven tasks; the
  collate length is clamped to the position table;
- a pretrain ``state_dict`` imported into the CORD finetune task gives the
  JAX import's parameters exactly (the pretrain rows, and the new rows the
  resize replay draws);
- from those weights, on the collated batch, the CORD step-1 loss and every
  gradient are within atol = rtol = 5e-4 of JAX's (the bound
  ``tests/test_torch_train_step.py`` uses), dropout off on both sides;
- xent: the encoder imported from the pretrain checkpoint equals the JAX
  task's; with the JAX head carried over, ``state_dict`` has the JAX task's
  keys and values, and the step-1 loss (within 5e-4) and accuracy match.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.parallel.mesh import MeshEnv
from pixparse_tpu.task import TASK_CLASS_REGISTRY as JAX_REGISTRY
from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.task import TaskEval, TaskTrain
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
from pixparse_tpu_torch.tokenizers import TokenizerCfg

TASKS = sorted(n for n in TASK_CLASS_REGISTRY  # the finetune and JSON eval tasks
               if n.startswith("cruller_") and n not in ("cruller_pretrain", "cruller_eval_ocr"))


def _cfg(registry, name, tok_cls, opt_cls, **kw):
    cfg_cls = registry[name][1]
    if "opt" in {f.name for f in dataclasses.fields(cfg_cls)}:
        kw.setdefault("opt", opt_cls(learning_rate=1e-3))
    return cfg_cls(model_name="cruller_test", tokenizer=tok_cls(name="pixparse_bytelevel"), **kw)


def _pair(name):
    """The JAX task and the port's, same config."""
    jtask = JAX_REGISTRY[name][0](_cfg(JAX_REGISTRY, name, JaxTokCfg, JaxOptCfg),
                                  MeshEnv.initialize(), None)
    ttask = TASK_CLASS_REGISTRY[name][0](
        _cfg(TASK_CLASS_REGISTRY, name, TokenizerCfg, OptimizationCfg, device="cpu"),
        DeviceEnv.initialize("cpu"))
    return jtask, ttask


def _page(seed, size=(80, 60)):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, size, np.uint8), "L")


CORD_ITEMS = [
    {"image": _page(0), "ground_truth": str({"gt_parse": {
        "menu": [{"nm": "latte", "cnt": "2", "price": "9.00"}, {"nm": "tea", "price": "3"}],
        "total": {"total_price": "12.00", "cashprice": "20.00", "changeprice": "8.00"}}})},
    {"image": _page(1), "ground_truth": {"gt_parse": {
        "menu": {"nm": "Über bagel", "unitprice": "1.5"}, "sub_total": {"tax_price": "0.1"}}}},
    {"image": _page(2), "ground_truth": str({"gt_parse": {"menu": {"nm": "x" * 300}}})},  # truncated
]


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "image":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("name", TASKS)
def test_registry_and_vocabulary_like_jax(name):
    jtask, ttask = _pair(name)
    assert isinstance(ttask, TaskTrain if "finetune" in name else TaskEval)
    assert type(ttask).__name__ == type(jtask).__name__
    for attr in ("vocab_size", "vocab_size_base", "newly_added_num", "collate_text_length",
                 "max_position_embeddings", "task_start_token", "prompt_end_token"):
        assert getattr(ttask, attr) == getattr(jtask, attr), attr
    for tok in (ttask.finetune_special_tokens or []) + ttask.base_special_tokens:
        assert ttask.tokenizer.convert_tokens_to_ids(tok) == jtask.tokenizer.convert_tokens_to_ids(tok)
    assert ttask.collate_text_length <= ttask.max_position_embeddings


def test_registry_holds_nine_tasks_under_the_jax_names():
    """The nine Cruller tasks, under the JAX package's names."""
    cruller = {n for n in TASK_CLASS_REGISTRY if n.startswith("cruller_")}
    assert cruller == {n for n in JAX_REGISTRY if n.startswith("cruller_")}
    assert len(cruller) == 9


def test_registry_holds_every_jax_task_but_pix2struct():
    assert set(TASK_CLASS_REGISTRY) == set(JAX_REGISTRY) - {"pix2struct_pretrain"}
    assert len(TASK_CLASS_REGISTRY) == 10


@pytest.mark.parametrize("name", ["cruller_finetune_cord", "cruller_eval_cord"])
def test_cord_collate_equal_to_jax(name):
    jtask, ttask = _pair(name)
    got, want = ttask.collate_fn(CORD_ITEMS), jtask.collate_fn(CORD_ITEMS)
    _assert_batches_equal(got, want)
    assert got["label"].shape == (3, 127)  # 512 clamped to the 128 positions, shifted
    # the long one is cut: no pad, and the shift drops the prompt
    assert (got["text_target"][2] != -100).all()


def test_docvqa_collate_equal_to_jax():
    jtask, ttask = _pair("cruller_finetune_docvqa")
    items = [{"image": _page(i), "labels": [
        f"<s_question>q{i}{j}?</s_question><s_answer>answer {i} {j}</s_answer>" for j in range(5)]}
        for i in range(4)]
    np.random.seed(123)
    want = jtask.collate_fn(items)
    np.random.seed(123)
    got = ttask.collate_fn(items)
    _assert_batches_equal(got, want)
    ans = ttask.tokenizer.convert_tokens_to_ids("<s_answer>")
    for lbl, tgt in zip(got["label"], got["text_target"]):
        pos = int(np.nonzero(lbl == ans)[0][0])
        assert (tgt[:pos] == -100).all() and (tgt[pos:] != -100).any()


def test_rvlcdip_collates_equal_to_jax():
    jtask, ttask = _pair("cruller_finetune_rvlcdip")
    items = [{"image": _page(i), "label": i} for i in range(16)]
    _assert_batches_equal(ttask.collate_fn(items), jtask.collate_fn(items))
    jeval, teval = _pair("cruller_eval_rvlcdip")
    bad = items[:3] + [{"image": None, "label": 4}]
    _assert_batches_equal(teval.collate_fn(bad), jeval.collate_fn(bad))
    assert teval.collate_fn([{"image": None, "label": 1}]) is jeval.collate_fn(
        [{"image": None, "label": 1}]) is None
    jx, tx = _pair("cruller_finetune_xent")
    _assert_batches_equal(tx.collate_fn(items), jx.collate_fn(items))


@pytest.fixture(scope="module")
def pretrain_state_dict():
    """A JAX pretrain task's reference-layout state dict (vocab 262)."""
    jpre, _ = _pair("cruller_pretrain")
    jpre.train_setup(num_batches_per_interval=2)
    return jpre.state_dict()


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def cord_pair(pretrain_state_dict):
    jtask, ttask = _pair("cruller_finetune_cord")
    jtask.resume_state_dict = dict(pretrain_state_dict)
    ttask.resume_state_dict = _torch_sd(pretrain_state_dict)
    jtask.train_setup(num_batches_per_interval=2)
    ttask.train_setup(num_batches_per_interval=2)
    return jtask, ttask


def test_pretrain_checkpoint_imports_like_jax(cord_pair, pretrain_state_dict):
    jtask, ttask = cord_pair
    want = cruller_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtask.state.params), jtask.vit_cfg, jtask.bart_cfg,
        tied_head=False)
    assert set(ttask.state.params) == set(want)
    for k, v in ttask.state.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k].numpy(), err_msg=k)
    table = ttask.model.tied_embedding.detach().numpy()
    old = pretrain_state_dict["text_decoder.trunk.model.decoder.embed_tokens.weight"]
    assert table.shape[0] == ttask.vocab_size > old.shape[0] == ttask.vocab_size_base
    np.testing.assert_array_equal(table[: old.shape[0]], old)


def test_cord_step_one_loss_and_gradients_match_jax(cord_pair):
    jtask, ttask = cord_pair
    items = CORD_ITEMS + [dict(CORD_ITEMS[0], image=_page(9)), dict(CORD_ITEMS[1], image=_page(8))]
    jb = jtask.normalize_batch(jtask.collate_fn(items))
    tb = ttask.normalize_batch(ttask.collate_fn(items))
    for k in ("text", "target"):
        np.testing.assert_array_equal(tb[k], jb[k])

    def jax_loss_fn(params):
        hidden = jtask.model.apply({"params": params}, jnp.asarray(jb["image"]),
                                   jnp.asarray(jb["text"]), deterministic=True,
                                   method="forward_hidden")
        emb = params["text_decoder"]["embed_tokens"]["embedding"].astype(hidden.dtype)
        return jax_loss.cross_entropy_from_hidden(hidden, emb, jnp.asarray(jb["target"]))[0]

    jl, jgrads = jax.value_and_grad(jax_loss_fn)(jtask.state.params)
    want = cruller_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), jtask.vit_cfg,
                                       jtask.bart_cfg, tied_head=False)
    ttask.model.eval()  # dropout off, as deterministic=True
    try:
        loss, _ = ttask.loss_fn(ttask._to_device(tb))
        names = list(ttask.state.params)
        grads = torch.autograd.grad(loss, [ttask.state.params[n] for n in names])
    finally:
        ttask.model.train()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=5e-4, rtol=5e-4)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def test_finetune_train_step_falls_on_a_repeated_batch(cord_pair):
    """Through the task's own ``train_step`` (dropout on): finite losses that
    fall over four AdamW steps on one batch."""
    _, ttask = cord_pair
    batch = ttask.collate_fn(CORD_ITEMS)
    losses = [float(ttask.train_step(batch)["loss"]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert ttask.state.step == ttask.step_idx == 4


def test_xent_import_state_dict_and_step_one_like_jax(pretrain_state_dict):
    jtask, ttask = _pair("cruller_finetune_xent")
    jtask.resume_state_dict = dict(pretrain_state_dict)
    ttask.resume_state_dict = _torch_sd(pretrain_state_dict)
    jtask.train_setup(num_batches_per_interval=2)
    ttask.train_setup(num_batches_per_interval=2)
    want = jtask.state_dict()
    got = ttask.state_dict()
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == {"encoder", "final_fc"}
    for k in got:
        if k.startswith("encoder."):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            np.testing.assert_array_equal(
                got[k].numpy(), pretrain_state_dict["image_" + k], err_msg=k)
    assert got["final_fc.weight"].shape == (16, ttask.vit_cfg.embed_dim)
    # the JAX head carried over: every value is the JAX task's
    ttask.model.load_state_dict(_torch_sd(want), strict=True)
    for k, v in ttask.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)

    batch = jtask.collate_fn([{"image": _page(i), "label": i % 16} for i in range(8)])
    jb = jtask.normalize_batch(batch)
    _, jm = jtask.train_step_fn(jtask.state, jtask.device_env.shard_batch(jb))
    _, tm = ttask.train_step_fn(ttask.state, ttask._to_device(ttask.normalize_batch(batch)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=5e-4, rtol=5e-4)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == 0
