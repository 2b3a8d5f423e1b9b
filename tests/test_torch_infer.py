"""The port's serving entry point and host-side pieces against the JAX
package's, on the CPU.

- ``pixparse_tpu_torch.app.infer`` with ``--task.device cpu`` writes the
  same JSONL as ``pixparse_tpu.app.infer`` for the same ``.pt`` checkpoint
  (5 pages at batch 4, so the final batch is padded);
- the pure-Python ``pixparse_bytelevel`` tokenizer gives the same ids and
  decoded strings as the JAX package's HF-wrapped one;
- the legacy eval transform matches ``create_transforms("legacy")``.

The CUDA kernels on the serving path are held against their plain
versions only on the card (chip_smoke.py).
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn
from PIL import Image

from pixparse_tpu.app.infer import main as jax_infer_main
from pixparse_tpu.data.transforms import create_transforms as jax_create_transforms
from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models.torch_interop import cruller_params_to_torch
from pixparse_tpu.task.common import add_special_tokens as jax_add_special_tokens
from pixparse_tpu.tokenizers import create_bytelevel_tokenizer
from pixparse_tpu_torch.app.infer import main as infer_main
from pixparse_tpu_torch.data.transforms import create_transforms
from pixparse_tpu_torch.task.common import SPECIAL_TOKENS_FROM_PRETRAIN, add_special_tokens
from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer

VOCAB = 262  # 260 byte-level ids + <sep/> + <s_pretrain>


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    d = tmp_path_factory.mktemp("pages")
    rng = np.random.RandomState(0)
    for i in range(5):
        img = Image.fromarray(rng.randint(0, 255, (64, 48), np.uint8), "L")
        img.save(d / f"page-{i:02d}.png")
    return str(d)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout ``.pt`` from the JAX package's own exporter, with
    weights redrawn from a numpy seed so greedy text varies."""
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb)
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 1)), jnp.zeros((1, 4), jnp.int32)
    ))["params"]
    scales = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}

    def redraw(path, x):
        std = scales.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    params = jax.tree_util.tree_map_with_path(redraw, init)
    sd = cruller_params_to_torch(params, jv, jb)
    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


def test_infer_jsonl_identical_to_jax(pages, checkpoint, tmp_path):
    flags = [
        "--infer.task_name", "cruller_eval_ocr",
        "--infer.images", pages,
        "--infer.checkpoint_path", checkpoint,
        "--infer.batch_size", "4",
        "--infer.max_new_tokens", "12",
        "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel",
        "--task.dtype", "float32",
    ]
    ref_out, out = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    assert jax_infer_main(flags + ["--infer.output", ref_out]) == 0
    assert infer_main(flags + ["--infer.output", out, "--task.device", "cpu"]) == 0
    ref = open(ref_out, encoding="utf-8").read()
    got = open(out, encoding="utf-8").read()
    assert len(got.strip().splitlines()) == 5
    assert len({line for line in got.splitlines()}) > 1  # pages differ
    assert got == ref


def test_infer_defaults_to_cuda_and_runs_continuous_on_the_cpu(pages, tmp_path):
    flags = ["--infer.images", pages, "--task.model_name", "cruller_test",
             "--task.tokenizer.name", "pixparse_bytelevel"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            infer_main(flags)
    out = str(tmp_path / "continuous.jsonl")
    assert infer_main(flags + ["--infer.continuous", "true", "--task.device", "cpu",
                               "--infer.max_new_tokens", "4", "--infer.output", out]) == 0
    assert len(open(out, encoding="utf-8").read().strip().splitlines()) == 5
    with pytest.raises(SystemExit):  # not a Cruller eval task: app.eval only, as in JAX
        infer_main(["--infer.task_name", "donut_eval_ocr", "--infer.images", pages])


@pytest.mark.parametrize("device_preprocess", ["false", "true"])
def test_infer_continuous_equals_batched_and_jax(pages, checkpoint, tmp_path, device_preprocess):
    """The counterpart of the JAX package's
    ``test_infer_cli_continuous_matches_batched``: ``--infer.continuous``
    (2 slots, pools encoded 2 pages at a time) and the batched path write the
    same record for every file, and both equal the JAX CLI's batched JSONL;
    the same with the pages normalized on the device."""
    flags = [
        "--infer.task_name", "cruller_eval_ocr",
        "--infer.images", pages,
        "--infer.checkpoint_path", checkpoint,
        "--infer.batch_size", "2",
        "--infer.max_new_tokens", "8",
        "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel",
        "--task.dtype", "float32",
    ]
    port = flags + ["--task.device", "cpu", "--task.device_preprocess", device_preprocess]
    outs = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "batched", "continuous")}
    assert jax_infer_main(flags + ["--infer.output", outs["jax"]]) == 0
    assert infer_main(port + ["--infer.output", outs["batched"]]) == 0
    assert infer_main(port + ["--infer.output", outs["continuous"], "--infer.continuous", "true",
                              "--infer.refill_size", "2", "--infer.chunk_steps", "3"]) == 0
    texts = {k: open(v, encoding="utf-8").read() for k, v in outs.items()}
    assert len(texts["jax"].strip().splitlines()) == 5
    assert len(set(texts["jax"].splitlines())) > 1  # pages differ
    assert texts["continuous"] == texts["batched"] == texts["jax"]


def _tokenizer_pair():
    ref = create_bytelevel_tokenizer()
    jax_add_special_tokens(ref, SPECIAL_TOKENS_FROM_PRETRAIN)
    tok = ByteLevelTokenizer()
    assert add_special_tokens(tok, SPECIAL_TOKENS_FROM_PRETRAIN) == 2
    assert add_special_tokens(tok, SPECIAL_TOKENS_FROM_PRETRAIN) == 0
    return ref, tok


def test_bytelevel_tokenizer_matches_hf():
    ref, tok = _tokenizer_pair()
    assert len(tok) == len(ref) == VOCAB
    assert (tok.pad_token_id, tok.eos_token_id, tok.bos_token_id) == (
        ref.pad_token_id, ref.eos_token_id, ref.bos_token_id)
    rng = random.Random(0)
    pieces = ["a", "Z", " ", "é", "日本", "\n", "\t", ".", " 't", "😀", "\x00", "<s>", "</s>",
              "<pad>", "<unk>", "<s_pretrain>", "<sep/>", "<s", "<sep", "<<s>>", "<s_pre"]
    for _ in range(500):
        text = "".join(rng.choice(pieces) for _ in range(rng.randint(0, 12)))
        assert tok.encode(text, add_special_tokens=False) == ref.encode(text, add_special_tokens=False)
        ids = [rng.randrange(VOCAB) for _ in range(rng.randint(0, 24))]
        for skip in (False, True):
            assert tok.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip)
    batch = [[rng.randrange(VOCAB) for _ in range(10)] for _ in range(4)]
    assert tok.batch_decode(batch) == ref.batch_decode(batch, skip_special_tokens=False)


def test_bytelevel_added_tokens_match_hf_and_reload(tmp_path):
    """Plain added tokens (a vocabulary padded to a published height) take the
    ids HF gives them, are split out whole by encode, survive
    decode(skip_special_tokens=True), and come back from a saved directory
    whose path is the tokenizer's name."""
    from pixparse_tpu_torch.tokenizers import TokenizerCfg, create_tokenizer

    ref, tok = _tokenizer_pair()
    fillers = [f"<filler_{i}>" for i in range(300)]
    assert tok.add_tokens(fillers) == ref.add_tokens(fillers) == 300
    assert tok.add_tokens(fillers[:5] + ["<sep/>"]) == 0
    assert len(tok) == len(ref) == VOCAB + 300
    tok.save_pretrained(str(tmp_path))
    again = create_tokenizer(TokenizerCfg(name=str(tmp_path)))
    assert len(again) == len(tok) and again.all_special_tokens == tok.all_special_tokens
    rng = random.Random(1)
    pieces = ["a", "<", "é", "<filler_1>", "<filler_12>", "<filler_299>", "<filler_", "<sep/>",
              "<s_pretrain>", ">", "1"]
    for _ in range(300):
        text = "".join(rng.choice(pieces) for _ in range(rng.randint(0, 10)))
        want = ref.encode(text, add_special_tokens=False)
        assert tok.encode(text) == want and again.encode(text) == want
        ids = [rng.randrange(VOCAB + 300) for _ in range(rng.randint(0, 16))]
        for skip in (False, True):
            want = ref.decode(ids, skip_special_tokens=skip)
            assert tok.decode(ids, skip_special_tokens=skip) == want
            assert again.decode(ids, skip_special_tokens=skip) == want


@pytest.mark.parametrize("shape", [(64, 48), (101, 77), (40, 90)])
def test_legacy_eval_transform_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape, np.uint8)
    ref = jax_create_transforms("legacy", (64, 48), training=False)
    port = create_transforms("legacy", (64, 48), training=False)
    for x in (img, Image.fromarray(img, "L")):
        out = port(x)
        assert out.shape == (64, 48, 1) and out.dtype == np.float32
        np.testing.assert_array_equal(out, ref(x))
    # 'better' builds too: its eval branch keeps the aspect and pads, as JAX's
    better = create_transforms("better", (64, 48), training=False)
    np.testing.assert_array_equal(better(img), jax_create_transforms("better", (64, 48))(img))
