"""The port's CORD, DocVQA and RVL-CDIP eval tasks against the JAX
package's, on the CPU at ``cruller_test`` (fp32): one reference-layout
checkpoint at the task's vocabulary (a JAX init redrawn from a numpy seed,
so greedy decoding reads out varied tokens) loads into both; on the same
collated batch the greedy token ids are EQUAL (DocVQA with ragged question
prompts, left-aligned by ``generate``), and so are the metrics
``average_metrics`` reports (nTED accuracy and F1, ANLS, classification
accuracy). ``evaluate`` over the port's ``HfDatasetLoader`` counts every
readable RVL-CDIP page, an all-unreadable batch included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch
from flax import linen as nn
from PIL import Image

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models.torch_interop import cruller_params_to_torch
from pixparse_tpu.parallel.mesh import MeshEnv
from pixparse_tpu.task import TASK_CLASS_REGISTRY as JAX_REGISTRY
from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
from pixparse_tpu_torch.data.loader import HfDatasetLoader
from pixparse_tpu_torch.data.wds import LoaderBundle
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework.eval import evaluate
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
from pixparse_tpu_torch.tokenizers import TokenizerCfg

SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}


def _page(seed, size=(80, 60)):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, size, np.uint8), "L")


def _checkpoint(vit_cfg, bart_cfg, seed=0):
    init = nn.unbox(JaxCruller(vit_cfg, bart_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *vit_cfg.img_size, vit_cfg.in_chans)),
        jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.RandomState(seed)

    def redraw(p, x):
        std = SCALES.get(str(getattr(p[-1], "key", p[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    sd = cruller_params_to_torch(jax.tree_util.tree_map_with_path(redraw, init), vit_cfg, bart_cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _pair(name, seed=0):
    jtask = JAX_REGISTRY[name][0](JAX_REGISTRY[name][1](
        model_name="cruller_test", tokenizer=JaxTokCfg(name="pixparse_bytelevel")),
        MeshEnv.initialize(), None)
    ttask = TASK_CLASS_REGISTRY[name][0](TASK_CLASS_REGISTRY[name][1](
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"), device="cpu"),
        DeviceEnv.initialize("cpu"))
    ckpt = _checkpoint(jtask.vit_cfg, jtask.bart_cfg, seed)
    for task in (jtask, ttask):
        task.resume_state_dict = dict(ckpt)
        task.setup()
    return jtask, ttask


def _same_steps(jtask, ttask, batches):
    """Each batch through both tasks' ``step``; the per-batch metrics and
    then ``average_metrics`` must be equal."""
    jm, tm = {}, {}
    for i, batch in enumerate(batches):
        jm[i] = jtask.step(batch)
        tm[i] = ttask.step(batch)
        assert tm[i] == jm[i]
    got, want = ttask.average_metrics(tm), jtask.average_metrics(jm)
    assert got == want
    return got


def test_cord_eval_tokens_and_metrics_equal_to_jax():
    jtask, ttask = _pair("cruller_eval_cord")
    items = [{"image": _page(i), "ground_truth": str({"gt_parse": {
        "menu": [{"nm": f"item {i}", "price": f"{i}.00"}], "total": {"total_price": str(i)}}})}
        for i in range(3)]
    batch = ttask.collate_fn(items)
    prompt = ttask.prompt_ids(ttask.task_start_token, 3)
    np.testing.assert_array_equal(prompt, jtask.prompt_ids(jtask.task_start_token, 3))
    assert ttask.max_generation_length == jtask.max_generation_length == 128
    got = ttask.generate_ids(batch["image"], prompt, ttask.max_generation_length)
    want = jtask.generate_ids(batch["image"], prompt, jtask.max_generation_length)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:, 1:])) > 3  # varied tokens, not one repeated id
    metrics = _same_steps(jtask, ttask, [batch, ttask.collate_fn(items[:1])])
    assert set(metrics) == {"average_accuracy", "f1_score"}
    assert ttask.acc_list == []  # the accumulators are reset


def test_docvqa_eval_ragged_prompts_tokens_and_anls_equal_to_jax():
    jtask, ttask = _pair("cruller_eval_docvqa", seed=1)
    questions = ["what?", "what is the total amount due on this page?", "who signed it"]
    items = [{"image": _page(i), "labels": {"question": q, "answers": [f"answer {i}", "x"]},
              "question_id": i} for i, q in enumerate(questions)]
    batch = ttask.collate_fn(items)
    prompts = ttask.batch_prompts(batch["questions"])
    np.testing.assert_array_equal(prompts, jtask._batch_prompts(batch["questions"]))
    pad = ttask.tokenizer.pad_token_id
    assert len({int((row != pad).sum()) for row in prompts}) == 3  # three prompt lengths
    got = ttask.generate_ids(batch["images"], prompts, 64)
    want = jtask.generate_ids(batch["images"], prompts, 64)
    np.testing.assert_array_equal(got, want)
    metrics = _same_steps(jtask, ttask, [batch])
    assert set(metrics) == {"ANLS"} and 0.0 <= metrics["ANLS"] <= 1.0
    assert ttask.all_predictions == []


def test_rvlcdip_eval_tokens_and_accuracy_equal_to_jax():
    jtask, ttask = _pair("cruller_eval_rvlcdip", seed=2)
    items = [{"image": _page(i), "label": i} for i in range(16)]
    batch = ttask.collate_fn(items)
    prompt = ttask.prompt_ids(ttask.task_start_token, 16)
    got = ttask.generate_ids(batch["image"], prompt, ttask.max_generation_length)
    want = jtask.generate_ids(batch["image"], prompt, jtask.max_generation_length)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 6)
    metrics = _same_steps(jtask, ttask, [batch, None])
    assert set(metrics) == {"classification"}
    c = ttask.step(batch)["classification"]
    assert c["n_valid_samples"] == 16


def test_rvlcdip_unreadable_batch_reaches_step_through_the_ports_loader():
    _, ttask = _pair("cruller_eval_rvlcdip", seed=2)
    items = [{"image": _page(0), "label": 1}, {"image": _page(1), "label": 2},
             {"image": None, "label": 3}, {"image": None, "label": 4},
             {"image": _page(4), "label": 5}]
    loader = HfDatasetLoader(items, 2, ttask.collate_fn, is_train=False, num_workers=1)
    seen = []
    step = ttask.step
    ttask.step = lambda sample: (seen.append(sample is None), step(sample))[1]
    metrics = evaluate(ttask, {"eval": LoaderBundle(loader=loader, num_batches=3, num_samples=5)})
    assert seen == [False, True, False]
    assert set(metrics["eval"]["average"]["classification"]) == {"accuracy"}
