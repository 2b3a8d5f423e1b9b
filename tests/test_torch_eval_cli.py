"""The port's eval CLI against the JAX package's, on the CPU.

One tar shard of PNG pages + JSON annotations and one ``.pt`` checkpoint
written by the JAX package's ``cruller_params_to_torch`` from a JAX init
tree redrawn from a numpy seed (no training: random weights still read out
varied bytes, so CER/WER exist):

- ``pixparse_tpu_torch.app.eval --task.device cpu`` and
  ``pixparse_tpu.app.eval`` write the same metrics file name and the same
  CER/WER at ``cruller_test`` fp32, in the bf16 mode and with the int8
  flags (``--task.kv-cache-dtype int8 --task.lm-head-dtype int8``);
- with ``--task.device_preprocess true`` (uint8 canvases, normalized on
  the device) the port writes the same metrics file as without the flag,
  which is the JAX CLI's without it;
- an RGB shard at ``cruller_swin_test`` runs through the port's
  ``app.eval`` and ``app.infer``;
- unregistered tasks, S3 and a missing checkpoint are refused.
"""

import io
import json
import os
import tarfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn
from PIL import Image

from pixparse_tpu.app.eval import main as jax_eval_main
from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models.torch_interop import cruller_params_to_torch
from pixparse_tpu_torch.app.eval import main as eval_main
from pixparse_tpu_torch.app.infer import main as infer_main

VOCAB = 262  # 260 byte-level ids + <sep/> + <s_pretrain>
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5,
          "relative_position_bias_table": 0.5}


def _make_shard(path, n, mode="L", size=(80, 60)):
    rng = np.random.RandomState(0)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            shape = size + ((3,) if mode == "RGB" else ())
            img = Image.fromarray(rng.randint(0, 255, shape, np.uint8), mode)
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            for name, data in ((f"{i:05d}.png", buf.getvalue()), (f"{i:05d}.json", json.dumps(
                    {"pages": [{"text": [f"hello world {i}", "the quick brown fox"]}]}).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _checkpoint(path, model_name, image_size, in_chans):
    jv, jb, _ = jax_resolve(jax_model_config(model_name), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb)
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *image_size, in_chans)), jnp.zeros((1, 4), jnp.int32)
    ))["params"]

    def redraw(p, x):
        std = SCALES.get(str(getattr(p[-1], "key", p[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    sd = cruller_params_to_torch(jax.tree_util.tree_map_with_path(redraw, init), jv, jb)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    shard = str(d / "shard-00000.tar")
    _make_shard(shard, 8)
    return shard, _checkpoint(d / "model.pt", "cruller_test", (64, 48), 1)


def _flags(shard, ckpt, out_dir, model_name="cruller_test", extra=()):
    return [
        "--eval.task_name", "cruller_eval_ocr",
        "--eval.output_dir", out_dir,
        "--eval.checkpoint_path", ckpt,
        "--eval.dataset_name", "FUNSD",
        "--task.model_name", model_name,
        "--task.tokenizer.name", "pixparse_bytelevel",
        "--task.dtype", "float32",
        "--data.eval.source", shard,
        "--data.eval.num_samples", "8",
        "--data.eval.batch_size", "4",
        "--data.eval.split", "eval",
        "--data.eval.num_workers", "1",
        *extra,
    ]


def _metrics(out_dir):
    [name] = [f for f in os.listdir(out_dir) if f.endswith("-metrics.json")]
    with open(os.path.join(out_dir, name)) as fh:
        return name, json.load(fh)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_eval_metrics_equal_to_jax(data, tmp_path, mode):
    shard, ckpt = data
    extra = ["--task.kv-cache-dtype", "int8", "--task.lm-head-dtype", "int8"] if mode == "int8" else []
    ref_dir, out_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_eval_main(_flags(shard, ckpt, ref_dir, extra=extra)) == 0
    assert eval_main(_flags(shard, ckpt, out_dir, extra=extra + ["--task.device", "cpu"])) == 0
    ref_name, ref = _metrics(ref_dir)
    name, got = _metrics(out_dir)
    assert name == ref_name == ckpt.replace("/", "_").replace(".pt", "") + "-FUNSD-metrics.json"
    assert set(got) == {"eval"} and set(got["eval"]["average"]) == {"cer", "wer"}
    assert got == ref


def test_eval_device_preprocess_writes_the_same_metrics(data, tmp_path):
    shard, ckpt = data
    ref_dir = str(tmp_path / "jax")
    assert jax_eval_main(_flags(shard, ckpt, ref_dir)) == 0
    got = {}
    for flag in ("false", "true"):
        out_dir = str(tmp_path / flag)
        assert eval_main(_flags(shard, ckpt, out_dir, extra=[
            "--task.device", "cpu", "--task.device_preprocess", flag])) == 0
        got[flag] = _metrics(out_dir)
    assert got["true"] == got["false"] == _metrics(ref_dir)


def test_swin_rgb_shard_through_eval_and_infer(tmp_path):
    shard = str(tmp_path / "rgb-00000.tar")
    _make_shard(shard, 4, mode="RGB", size=(70, 90))
    ckpt = _checkpoint(tmp_path / "swin.pt", "cruller_swin_test", (64, 64), 1)
    out_dir = str(tmp_path / "eval")
    flags = _flags(shard, ckpt, out_dir, "cruller_swin_test", ["--task.device", "cpu"])
    assert eval_main(flags) == 0
    _, metrics = _metrics(out_dir)
    assert all(np.isfinite(v) for v in metrics["eval"]["average"].values())

    pages = tmp_path / "pages"
    pages.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (70, 90, 3), np.uint8), "RGB").save(pages / f"p{i}.png")
    out = str(tmp_path / "ocr.jsonl")
    assert infer_main([
        "--infer.images", str(pages), "--infer.checkpoint_path", ckpt, "--infer.output", out,
        "--infer.batch_size", "2", "--infer.max_new_tokens", "8",
        "--task.model_name", "cruller_swin_test", "--task.tokenizer.name", "pixparse_bytelevel",
        "--task.dtype", "float32", "--task.device", "cpu",
        "--task.kv-cache-dtype", "int8", "--task.lm-head-dtype", "int8",
    ]) == 0
    records = [json.loads(line) for line in open(out, encoding="utf-8")]
    assert [os.path.basename(r["file"]) for r in records] == ["p0.png", "p1.png", "p2.png"]


def test_donut_base_resolves_for_the_entry_points():
    """``--task.model_name donut_base`` (run full size on the card only):
    the registered config gives the Swin-B window-10 encoder on 2560x1920
    RGB pages and the 57525-token pre-LN mBART decoder."""
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs
    from pixparse_tpu_torch.models.swin import SwinCfg
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg

    cfg = TaskCrullerEvalOCRCfg(model_name="donut_base", device="cpu")
    assert cfg.model.text_decoder.pad_token_id == 1
    enc, dec, stats = resolve_cruller_cfgs(cfg.model)
    assert isinstance(enc, SwinCfg) and enc.img_size == (2560, 1920) and enc.in_chans == 3
    assert (enc.num_tokens, enc.out_dim, enc.depth, enc.final_norm) == (4800, 1024, 20, False)
    assert (dec.vocab_size, dec.d_model, dec.decoder_layers) == (57525, 1024, 4)
    assert dec.pre_norm and dec.add_final_layer_norm and dec.scale_embedding
    assert stats == {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}


def test_eval_cli_refusals(data, tmp_path):
    shard, ckpt = data
    # a train task: app.eval refuses it and lists its eval tasks
    with pytest.raises(SystemExit, match=r"--eval.task_name must be one of \[.*cruller_eval_ocr") as e:
        eval_main(["--eval.task_name", "pix2struct_pretrain"])
    assert "pix2struct" not in str(e.value)
    flags = _flags(shard, ckpt, str(tmp_path / "o"), extra=["--task.device", "cpu"])
    with pytest.raises(NotImplementedError, match="s3"):
        eval_main(flags + ["--eval.s3_bucket", "bucket"])
    with pytest.raises(FileNotFoundError):
        eval_main(flags + ["--eval.checkpoint_path", str(tmp_path / "missing.pt")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_main(flags[:-2])
