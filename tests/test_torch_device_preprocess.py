"""``--task.device_preprocess`` in the port's train and eval tasks, on the
CPU at ``cruller_test`` (fp32, ``device="cpu"``): the host transform stops
at the uint8 canvas, the batch crosses to the device as uint8 and is
normalized there (``ops/preprocess.py::normalize_images``).

- train (``cruller_pretrain``, dropout off on both sides): one step's loss
  and every gradient with the flag are bit-equal to the port's step on the
  host-normalized batch, and within the train-step tests' bounds of the JAX
  task's step with the flag (loss 1e-5, gradients atol = rtol = 5e-4);
  through ``train_step`` (dropout on) the two port steps give the same
  loss;
- eval: the CORD, DocVQA and RVL-CDIP eval tasks collate uint8 canvases and
  their ``step`` gives the JAX task's metrics on its host-normalized batch;
  the greedy ids equal the JAX task's ``generate_ids`` with the flag on the
  same canvases. (``cruller_eval_ocr`` through ``app.eval``:
  ``tests/test_torch_eval_cli.py``.)
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
from pixparse_tpu.models.torch_interop import cruller_params_to_torch
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.ops.preprocess import normalize_images as jax_normalize_images
from pixparse_tpu.parallel.mesh import MeshEnv
from pixparse_tpu.task import TASK_CLASS_REGISTRY as JAX_REGISTRY
from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
from pixparse_tpu_torch.data.transforms import _as_float_normalized
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
from pixparse_tpu_torch.tokenizers import TokenizerCfg

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def _jax_task(name, **kw):
    cfg_cls = JAX_REGISTRY[name][1]
    if "opt" in {f.name for f in dataclasses.fields(cfg_cls)}:
        kw["opt"] = JaxOptCfg(learning_rate=1e-3)
    cfg = cfg_cls(model_name="cruller_test", tokenizer=JaxTokCfg(name="pixparse_bytelevel"), **kw)
    return JAX_REGISTRY[name][0](cfg, MeshEnv.initialize(), None)


def _task(name, **kw):
    cfg_cls = TASK_CLASS_REGISTRY[name][1]
    if "opt" in {f.name for f in dataclasses.fields(cfg_cls)}:
        kw["opt"] = OptimizationCfg(learning_rate=1e-3)
    cfg = cfg_cls(model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
                  device="cpu", **kw)
    return TASK_CLASS_REGISTRY[name][0](cfg, DeviceEnv.initialize("cpu"))


@pytest.fixture(scope="module")
def train_tasks():
    """The JAX pretrain task with the flag, and the port's with and without
    it, from the JAX task's weights; decoder dropout off in all three."""
    jtask = _jax_task("cruller_pretrain", device_preprocess=True)
    tasks = [jtask, _task("cruller_pretrain", device_preprocess=True),
             _task("cruller_pretrain")]
    for task in tasks:
        task.bart_cfg = dataclasses.replace(task.bart_cfg, **NO_DROPOUT)
    jtask.train_setup(num_batches_per_interval=2, seed=0)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jtask.state_dict().items()}
    for task in tasks[1:]:
        task.resume_state_dict = dict(sd)
        task.train_setup(num_batches_per_interval=2, seed=0)
    return tasks


def _train_batch(task, n=4):
    rng = np.random.RandomState(0)
    L = task.max_position_embeddings
    img8 = rng.randint(0, 256, (n, 64, 48, 1), np.uint8)
    imgf = np.stack([_as_float_normalized(im, task.img_mean, task.img_std) for im in img8])
    text = rng.randint(4, 200, (n, L)).astype(np.int64)
    target = rng.randint(4, 200, (n, L)).astype(np.int64)
    return img8, imgf, text, target


def _loss_and_grads(task, batch):
    task.model.eval()  # no dropout, as deterministic=True
    try:
        loss, _ = task.loss_fn(task._to_device(batch))
        names = list(task.state.params)
        grads = torch.autograd.grad(loss, [task.state.params[n] for n in names])
    finally:
        task.model.train()
    return loss.detach(), dict(zip(names, grads))


def test_train_step_with_device_preprocess_equals_the_host_path_and_jax(train_tasks):
    jtask, on, off = train_tasks
    img8, imgf, text, target = _train_batch(on)
    b_on = on.normalize_batch({"image": img8, "text": text, "target": target})
    b_off = off.normalize_batch({"image": imgf, "text": text, "target": target})
    assert b_on["image"].dtype == np.uint8 and b_off["image"].dtype == np.float32
    assert on._to_device(b_on)["image"].dtype == torch.uint8  # a quarter of the bytes
    loss_on, g_on = _loss_and_grads(on, b_on)
    loss_off, g_off = _loss_and_grads(off, b_off)
    assert torch.equal(loss_on, loss_off)
    for name, g in g_on.items():
        assert torch.equal(g, g_off[name]), name

    jb = jtask.normalize_batch({"image": img8, "text": text, "target": target})
    assert jb["image"].dtype == np.uint8
    mean, std = jnp.asarray(jtask.img_mean, jnp.float32), jnp.asarray(jtask.img_std, jnp.float32)

    def jax_loss_fn(params):  # the JAX task's loss_fn with its device normalize
        image = jax_normalize_images(jnp.asarray(jb["image"]), mean, std)
        hidden = jtask.model.apply({"params": params}, image, jnp.asarray(jb["text"]),
                                   deterministic=True, method="forward_hidden")
        emb = params["text_decoder"]["embed_tokens"]["embedding"].astype(hidden.dtype)
        return jax_loss.cross_entropy_from_hidden(hidden, emb, jnp.asarray(jb["target"]))[0]

    jl, jgrads = jax.value_and_grad(jax_loss_fn)(jtask.state.params)
    want = cruller_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), jtask.vit_cfg,
                                       jtask.bart_cfg, tied_head=False)
    assert abs(float(loss_on) - float(jl)) < 1e-5
    assert set(g_on) == set(want)
    for name, g in g_on.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)

    # the task's own step, dropout live: the same masks, the same loss
    step_on = float(on.train_step({"image": img8, "text": text, "target": target})["loss"])
    step_off = float(off.train_step({"image": imgf, "text": text, "target": target})["loss"])
    assert step_on == step_off and np.isfinite(step_on)


def _page(seed, size=(80, 60)):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, size, np.uint8), "L")


EVAL_ITEMS = {
    "cruller_eval_cord": lambda: [
        {"image": _page(i), "ground_truth": str({"gt_parse": {"menu": [{"nm": f"item {i}"}]}})}
        for i in range(3)],
    "cruller_eval_docvqa": lambda: [
        {"image": _page(i), "labels": {"question": q, "answers": [f"answer {i}"]},
         "question_id": i} for i, q in enumerate(["what?", "who signed it"])],
    "cruller_eval_rvlcdip": lambda: [{"image": _page(i), "label": i} for i in range(4)],
}


@pytest.mark.parametrize("name", list(EVAL_ITEMS))
def test_eval_tasks_with_device_preprocess_equal_the_host_path_and_jax(name):
    """The JAX host-path task's seed-0 weights, exported by the JAX package,
    in the JAX task with the flag and in the port's with the flag."""
    jhost, jdev, task = _jax_task(name), _jax_task(name, device_preprocess=True), _task(
        name, device_preprocess=True)
    jhost.setup()
    sd = cruller_params_to_torch(jax.tree_util.tree_map(np.asarray, jhost.params),
                                 jhost.vit_cfg, jhost.bart_cfg)
    for t in (jdev, task):
        t.resume_state_dict = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        t.setup()
    items = EVAL_ITEMS[name]()
    batch, jbatch = task.collate_fn(items), jhost.collate_fn(items)
    key = "images" if "images" in batch else "image"
    assert batch[key].dtype == np.uint8 and jbatch[key].dtype == np.float32
    n = batch[key].shape[0]
    prompt = task.prompt_ids(task.task_start_token, n)
    np.testing.assert_array_equal(task.generate_ids(batch[key], prompt, 8),
                                  jdev.generate_ids(batch[key], prompt, 8))
    assert task.step(batch) == jhost.step(jbatch)
