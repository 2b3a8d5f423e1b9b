"""Training a Swin Cruller (donut_base's architecture) in the port, against
the JAX package, on the CPU in fp32.

- one and two AdamW train steps at ``cruller_swin_test`` with the decoder
  switched to donut's pre-LN mBART layout, dropout 0, against the JAX train
  step: loss, gradient norm and every parameter within 1e-5 (fp32, other
  summation order; two steps of a 1e-3 learning rate);
- with ``layer_decay=0.75`` every parameter's learning-rate scale and
  weight-decay flag equal JAX's, at ``cruller_swin_test`` and at donut_base
  (built on the ``meta`` device, JAX's tree from ``jax.eval_shape``): Swin
  blocks past stage 0 get JAX's coarse per-stage depth;
- ``cruller_train_flops`` equals JAX's at both sizes;
- ``python -m pixparse_tpu_torch.app.train --task.model_name
  cruller_swin_test --task.device cpu`` on a shard of RGB pages runs an
  interval and saves both checkpoints, under every ``--task.remat`` flag.
"""

import dataclasses
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

from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
from pixparse_tpu.framework.optimization import create_optimizer as jax_create_optimizer
from pixparse_tpu.framework.optimization import default_weight_decay_mask as jax_decay_mask
from pixparse_tpu.framework.optimization import layer_decay_scales as jax_layer_scales
from pixparse_tpu.framework.profiling import cruller_train_flops as jax_train_flops
from pixparse_tpu.framework.train_state import create_train_state as jax_create_train_state
from pixparse_tpu.framework.train_state import make_train_step as jax_make_train_step
from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.parallel.mesh import create_mesh, shard_batch
from pixparse_tpu_torch.app.train import main as train_main
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.optimization import (
    create_optimizer,
    default_weight_decay_mask,
    flax_path_names,
    layer_decay_scales,
)
from pixparse_tpu_torch.framework.profiling import cruller_train_flops
from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.loss import cross_entropy_from_hidden

VOCAB = 200
SCHED = (10, 1, 10)  # num_intervals, num_warmup_intervals, updates_per_interval
OPT = dict(learning_rate=1e-3, warmup_learning_rate=1e-3)
MBART = dict(pre_norm=True, add_final_layer_norm=True, scale_embedding=True,
             dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def _batch(n=8, text_len=16, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, 64, 64, 1).astype(np.float32)
    txt = rng.randint(4, VOCAB, size=(n, text_len)).astype(np.int32)
    tgt = np.roll(txt, -1, axis=1).astype(np.int32)
    tgt[:, -1] = -100
    tgt[0, :3] = -100
    return {"image": img, "text": txt, "target": tgt}


def _by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(k.key) for k in path): leaf for path, leaf in flat}


def test_two_adamw_steps_follow_jax():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_swin_test"), vocab_size=VOCAB)
    jb = dataclasses.replace(jb, **MBART)
    jmodel = JaxCruller(jv, jb)
    mesh = create_mesh()
    depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
    tx, _ = jax_create_optimizer(JaxOptCfg(**OPT), *SCHED, **depth, wrap_multisteps=False)
    example = (jnp.zeros((8, 64, 64, 1)), jnp.zeros((8, 16), jnp.int32))
    jstate, _ = jax_create_train_state(jmodel, tx, mesh, example, seed=0)

    def jax_loss_fn(params, batch, rng):
        hidden = jmodel.apply({"params": params}, batch["image"], batch["text"],
                              deterministic=False, rngs={"dropout": rng}, method="forward_hidden")
        emb = params["text_decoder"]["embed_tokens"]["embedding"]
        return jax_loss.cross_entropy_from_hidden(hidden, emb, batch["target"])[0], {}

    jstep = jax_make_train_step(jax_loss_fn, tx, mesh, donate=False)

    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_swin_test"), vocab_size=VOCAB)
    b = dataclasses.replace(b, **MBART)
    model = Cruller(v, b).train()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    load_cruller_state_dict(model, cruller_state_dict_from_jax(params, v, b))
    model.decoder.dropout_generator = torch.Generator()
    optimizer, _ = create_optimizer(OptimizationCfg(**OPT), *SCHED, **depth)
    state = create_train_state(model, optimizer, seed=0)

    def loss_fn(batch):
        hidden = model.forward_hidden(batch["image"], batch["text"])
        return cross_entropy_from_hidden(hidden, model.tied_embedding, batch["target"])[0], {}

    step = make_train_step(loss_fn, optimizer, reseed=model.decoder.dropout_generator.manual_seed)
    for i in range(2):
        batch = _batch(seed=i)
        jstate, jm = jstep(jstate, shard_batch(mesh, batch))
        tb = {k: torch.from_numpy(x) if k == "image" else torch.from_numpy(x).long()
              for k, x in batch.items()}
        state, tm = step(state, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-5, i
        want = cruller_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate.params), v, b, tied_head=False)
        for name, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                       err_msg=f"step {i + 1} {name}")


def _port_params(name, device=None):
    v, b, _ = resolve_cruller_cfgs(get_model_config(name))
    if device is None:
        return v, b, dict(Cruller(v, b).named_parameters())
    with torch.device(device):
        return v, b, dict(Cruller(v, b).named_parameters())


def _jax_abstract_params(name):
    jv, jb, _ = jax_resolve(jax_model_config(name))
    img = jax.ShapeDtypeStruct((1, *jv.img_size, jv.in_chans), jnp.float32)
    txt = jax.ShapeDtypeStruct((1, 4), jnp.int32)
    tree = jax.eval_shape(JaxCruller(jv, jb).init, jax.random.PRNGKey(0), img, txt)
    return nn.unbox(tree["params"])


@pytest.mark.parametrize("name,device", [("cruller_swin_test", None), ("donut_base", "meta")])
def test_layer_decay_scales_and_decay_mask_match_jax(name, device):
    v, b, params = _port_params(name, device)
    jparams = _jax_abstract_params(name)
    paths = {n: flax_path_names(n) for n in params}
    assert set(paths.values()) == set(_by_path(jparams))
    depth = dict(encoder_depth=v.depth, decoder_layers=b.decoder_layers)
    want = _by_path(jax_layer_scales(jparams, 0.75, **depth))
    got = layer_decay_scales(params, 0.75, **depth)
    for n, path in paths.items():
        assert abs(got[n] - float(want[path])) < 1e-12, n
    mask = _by_path(jax_decay_mask(jparams))
    assert default_weight_decay_mask(params) == {n: bool(mask[p]) for n, p in paths.items()}
    if name == "donut_base":  # a block of stage 2 sits at JAX's stage depth, 1 + 2 * (20 // 4)
        max_depth = v.depth + b.decoder_layers + 2
        assert got["image_encoder.trunk.layers.2.blocks.13.attn.qkv.weight"] == 0.75 ** (max_depth - 11)


@pytest.mark.parametrize("name", ["cruller_swin_test", "donut_base"])
def test_train_flops_match_jax(name):
    v, b, _ = resolve_cruller_cfgs(get_model_config(name))
    jv, jb, _ = jax_resolve(jax_model_config(name))
    text_len = b.max_position_embeddings - 1
    assert cruller_train_flops(v, b, 2, text_len) == jax_train_flops(jv, jb, 2, text_len)


def _make_rgb_shard(path, n, seed=0):
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (80, 60, 3), np.uint8), "RGB").save(buf, "PNG")
            anno = json.dumps({"pages": [{"text": [f"page {i}", "a donut of text"]}]}).encode()
            for name, data in ((f"{i:05d}.png", buf.getvalue()), (f"{i:05d}.json", anno)):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def rgb_shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wds") / "shard-00000.tar")
    _make_rgb_shard(path, 8)
    return path


@pytest.mark.parametrize("remat", ["auto", "none", "full", "dots", "mlp", "gelu"])
def test_train_cli_trains_a_swin_cruller(rgb_shard, tmp_path, remat):
    out = str(tmp_path / "out")
    rc = train_main([
        "--train.task_name", "cruller_pretrain", "--train.experiment", "swin",
        "--train.output_dir", out, "--task.model_name", "cruller_swin_test",
        "--task.tokenizer.name", "pixparse_bytelevel", "--task.num_intervals", "1",
        "--task.num_warmup_intervals", "0", "--task.dtype", "float32", "--task.device", "cpu",
        "--task.remat", remat, "--data.train.source", rgb_shard,
        "--data.train.num_samples", "8", "--data.train.batch_size", "4",
        "--data.train.split", "train", "--data.train.num_workers", "1",
    ])
    assert rc == 0
    ckpt = os.path.join(out, "swin", "checkpoints", "swin")
    assert os.path.isfile(os.path.join(ckpt, "checkpoint-0.pt"))
    with open(os.path.join(ckpt, "checkpoint-0", "metadata.json")) as fh:
        assert json.load(fh) == {"interval": 0, "step": 2}
    sd = torch.load(os.path.join(ckpt, "checkpoint-0.pt"), weights_only=True)
    assert "image_encoder.trunk.layers.1.blocks.0.attn.relative_position_bias_table" in sd
