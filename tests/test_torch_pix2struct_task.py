"""The port's ``pix2struct_pretrain`` task on the CPU at ``pix2struct_test``:
registered under the JAX package's name, trains on host-patchified pages of
varied aspect (with and without gradient accumulation), its automatic remat
rule, the refused ``.pt`` resume, and ``app.train`` over a tar shard for one
interval. (Mirrors the JAX package's ``tests/test_tasks.py`` pix2struct
tests; its slow end-to-end JAX task is not run here.)"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from pixparse_tpu_torch.app.train import main as train_main
from pixparse_tpu_torch.data.wds import default_collate
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.models.pix2struct import Pix2StructCfg, Pix2StructCruller
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
from pixparse_tpu_torch.task.task_pix2struct_pretrain import (
    TaskPix2StructPretrain,
    TaskPix2StructPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import TokenizerCfg

TOK = TokenizerCfg(name="pixparse_bytelevel")


def _task(accum=1, **kw):
    cfg = TaskPix2StructPretrainCfg(
        model_name="pix2struct_test", tokenizer=TOK, device="cpu", num_intervals=1,
        num_warmup_intervals=0, opt=OptimizationCfg(learning_rate=1e-3, grad_accum_steps=accum),
        **kw,
    )
    return TaskPix2StructPretrain(cfg, DeviceEnv.initialize("cpu"))


def _batch(task, n=8, seed=0):
    """Per-page host patchify (as the webdataset pipe runs it), collated."""
    rng = np.random.RandomState(seed)
    L = task.max_position_embeddings
    samples = []
    for i in range(n):
        img = rng.randint(0, 255, (60 + 40 * i, 240 - 20 * i), np.uint8)  # varied aspect
        txt = rng.randint(4, 200, (L,)).astype(np.int64)
        samples.append((task.image_preprocess_train(img), txt, txt.copy()))
    return default_collate(samples)


def test_registered_under_the_jax_name_and_built_by_the_factory():
    assert TASK_CLASS_REGISTRY["pix2struct_pretrain"] == (
        TaskPix2StructPretrain, TaskPix2StructPretrainCfg)
    cfg = TaskPix2StructPretrainCfg(tokenizer=TOK, device="cpu")
    assert cfg.model_name == "pix2struct_base"
    assert cfg.model.image_encoder.image_size == (2048, 16)
    task, _ = TaskFactory.create_task("pix2struct_pretrain", cfg, DeviceEnv.initialize("cpu"))
    assert isinstance(task, TaskPix2StructPretrain) and isinstance(task.vit_cfg, Pix2StructCfg)
    v = task.vit_cfg
    assert (v.max_patches, v.patch_size, v.embed_dim, v.depth, v.num_heads, v.max_rows,
            v.in_chans) == (2048, 16, 768, 12, 12, 2048, 1)
    assert (task.bart_cfg.d_model, task.bart_cfg.decoder_layers,
            task.bart_cfg.max_position_embeddings) == (768, 4, 1024)


def test_trains_on_patchified_pages_and_the_loss_falls():
    task = _task()
    task.train_setup(num_batches_per_interval=2)
    assert isinstance(task.model, Pix2StructCruller) and task.model.remat is False
    batch = _batch(task)
    assert batch[0]["patches"].shape == (8, 64, 256)
    assert len(set(batch[0]["mask"].sum(-1).tolist())) > 1  # ragged valid counts
    losses = [float(task.train_step(batch)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert task.state.step == task.step_idx == 3
    sd = task.state_dict()
    assert "image_encoder.trunk.row_embed.weight" in sd


def test_grad_accumulation_two_trains():
    task = _task(accum=2)
    task.train_setup(num_batches_per_interval=4)
    halves = [_batch(task, n=4, seed=s) for s in (0, 1)]
    losses = []
    for _ in range(3):
        for half in halves:
            out = task.train_step(half)
        losses.append(float(out["loss"]))
    assert task.state.step == 3 and task.step_idx == 6
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_auto_remat_none_under_flash_full_on_the_plain_path_when_large():
    task = _task(attn_impl="flash")
    task.train_setup(num_batches_per_interval=2)
    assert task.model.remat is False
    small = _task(attn_impl="xla")
    small.train_setup(num_batches_per_interval=2)
    assert small.model.remat is False  # 64 x 2 token-layers
    base = lambda impl: TaskPix2StructPretrain(
        TaskPix2StructPretrainCfg(tokenizer=TOK, device="cpu", attn_impl=impl),
        DeviceEnv.initialize("cpu"))
    assert base("flash").auto_remat() is False
    assert base("xla").auto_remat() is True  # 2048 x 12 > 20000: full remat
    assert base("auto").auto_remat() is True  # auto on the CPU: the plain path


def test_resume_from_a_pt_raises():
    task = _task()
    task.resume_state_dict = {"image_encoder.trunk.norm.weight": torch.ones(64)}
    with pytest.raises(NotImplementedError, match="no reference .pt layout"):
        task.train_setup(num_batches_per_interval=2)


def _make_shard(path, n, seed=0):
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = Image.fromarray(rng.randint(0, 255, (80 + 9 * i, 60 + 4 * i), np.uint8), "L")
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            for name, data in ((f"{i:05d}.png", buf.getvalue()), (f"{i:05d}.json", json.dumps(
                    {"pages": [{"text": [f"hello world {i}", "the quick brown fox"]}]}).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_app_train_runs_one_interval_on_the_cpu(tmp_path):
    shard = str(tmp_path / "shard-00000.tar")
    _make_shard(shard, 8)
    out = str(tmp_path / "out")
    rc = train_main([
        "--train.task_name", "pix2struct_pretrain", "--train.experiment", "p2s",
        "--train.output_dir", out, "--task.model_name", "pix2struct_test",
        "--task.tokenizer.name", "pixparse_bytelevel", "--task.dtype", "float32",
        "--task.device", "cpu", "--task.num_intervals", "1", "--task.num_warmup_intervals", "0",
        "--data.train.source", shard, "--data.train.num_samples", "8",
        "--data.train.batch_size", "4", "--data.train.split", "train",
        "--data.train.num_workers", "2",
    ])
    assert rc == 0
    ckpt = os.path.join(out, "p2s", "checkpoints", "p2s", "checkpoint-0.pt")
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert sd["image_encoder.trunk.patch_embed.weight"].shape == (64, 256)
    assert all(torch.isfinite(v).all() for v in sd.values())
