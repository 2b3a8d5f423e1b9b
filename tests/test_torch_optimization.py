"""The port's optimizer chain against the JAX package's optax chain: the same
numpy parameters and gradients (a ``cruller_test`` tree, so the paths are the
real ones) go through three updates of both, fp32, on the CPU.

Tolerance 1e-6 (absolute, on parameters of magnitude <= 1 and learning rates
<= 1e-2): both sides compute the same formulas in fp32 and differ only in
the order of a few roundings. With bf16 moments the stored state rounds at
the same points on both sides, and one bf16 ulp flip of a moment moves an
update by up to 1e-5, so that case gets 2e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
from pixparse_tpu.framework.optimization import create_optimizer as jax_create_optimizer
from pixparse_tpu.framework.optimization import create_scheduler as jax_create_scheduler
from pixparse_tpu.framework.optimization import default_weight_decay_mask as jax_decay_mask
from pixparse_tpu.framework.optimization import layer_decay_scales as jax_layer_scales
from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.optimization import (
    create_optimizer,
    create_scheduler,
    default_weight_decay_mask,
    flax_path_names,
    layer_decay_scales,
)
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax

VOCAB = 96
SCHED = dict(num_intervals=4, num_warmup_intervals=1, updates_per_interval=2)


@pytest.fixture(scope="module")
def trees():
    """(vit_cfg, bart_cfg, params, [grads x 3]) as numpy trees with flax paths."""
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    model = JaxCruller(jv, jb)
    img = jnp.zeros((1, *jv.img_size, 1))
    init = nn.unbox(model.init(jax.random.PRNGKey(0), img, jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.RandomState(0)
    draw = lambda scale: jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape) * scale).astype(np.float32), init)
    return jv, jb, draw(0.3), [draw(s) for s in (0.5, 2.0, 0.1)]


def _to_port(tree, jv, jb):
    return cruller_state_dict_from_jax(tree, jv, jb, tied_head=False)


def _run_both(trees, n_updates=3, **opt_kwargs):
    jv, jb, params, grads = trees
    depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
    tx, _ = jax_create_optimizer(JaxOptCfg(**opt_kwargs), **SCHED, **depth, wrap_multisteps=False)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    opt, _ = create_optimizer(OptimizationCfg(**opt_kwargs), **SCHED, **depth)
    tp = _to_port(params, jv, jb)
    tstate = opt.init(tp)
    for g in grads[:n_updates]:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tupd, tstate = opt.update(_to_port(g, jv, jb), tstate, tp)
        tp = {k: tp[k] + tupd[k] for k in tp}
    want = _to_port(jax.tree_util.tree_map(np.asarray, jp), jv, jb)
    return tp, want, tstate


def _assert_close(got, want, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(scheduler="cosine", learning_rate=5e-4, warmup_learning_rate=1e-5),
    dict(scheduler="constant", learning_rate=3e-4),
    dict(scheduler="linear", learning_rate=1e-3, warmup_learning_rate=1e-4),
], ids=lambda k: k["scheduler"])
@pytest.mark.parametrize("warmup", [0, 1])
def test_schedule_values_match_optax(kwargs, warmup):
    sched = dict(SCHED, num_warmup_intervals=warmup)
    want = jax_create_scheduler(JaxOptCfg(**kwargs), **sched)
    got = create_scheduler(OptimizationCfg(**kwargs), **sched)
    for count in range(0, 11):
        assert abs(float(got(count)) - float(want(count))) < 1e-9, count
        assert abs(float(got(torch.tensor(count))) - float(want(count))) < 1e-9, count


def test_paths_decay_mask_and_layer_scales_match_jax(trees):
    jv, jb, params, _ = trees
    tp = _to_port(params, jv, jb)
    assert flax_path_names("image_encoder.trunk.blocks.1.attn.qkv.weight") == (
        "image_encoder", "blocks_1", "attn", "qkv", "kernel")
    assert flax_path_names("image_encoder.trunk.patch_embed.proj.weight") == (
        "image_encoder", "patch_embed", "kernel")
    assert flax_path_names("text_decoder.trunk.model.decoder.layers.0.final_layer_norm.weight") == (
        "text_decoder", "layers_0", "final_layer_norm", "scale")
    assert flax_path_names("text_decoder.trunk.model.decoder.embed_tokens.weight") == (
        "text_decoder", "embed_tokens", "embedding")
    def by_path(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {tuple(str(k.key) for k in path): leaf for path, leaf in flat}

    # every port parameter names a leaf of the JAX tree, and all leaves are named
    paths = {name: flax_path_names(name) for name in tp}
    assert set(paths.values()) == set(by_path(params))
    mask = by_path(jax_decay_mask(params))
    got = default_weight_decay_mask(tp)
    assert {name: bool(mask[path]) for name, path in paths.items()} == got
    assert not got["image_encoder.trunk.pos_embed"] and not got["image_encoder.trunk.cls_token"]
    assert got["text_decoder.trunk.model.decoder.embed_tokens.weight"]
    scales = by_path(jax_layer_scales(params, 0.75, jv.depth, jb.decoder_layers))
    got = layer_decay_scales(tp, 0.75, jv.depth, jb.decoder_layers)
    for name, path in paths.items():
        assert abs(float(scales[path]) - got[name]) < 1e-6, name


@pytest.mark.parametrize("kwargs", [
    dict(),  # the defaults: adamw, cosine, weight decay 0.02, eps 1e-6
    dict(clip_grad_value=1.0, clip_grad_mode="norm"),
    dict(clip_grad_value=0.05, clip_grad_mode="value"),
    dict(clip_grad_value=0.02, clip_grad_mode="agc"),
    dict(layer_decay=0.75, weight_decay=0.05),
    dict(optimizer="adam", betas=(0.8, 0.95), eps=1e-8),
    dict(optimizer="sgd", learning_rate=1e-2, momentum=0.9),
    dict(optimizer="sgd", learning_rate=1e-2, momentum=0.0, weight_decay=0.0),
    dict(optimizer="momentum", learning_rate=1e-2),
    dict(optimizer="lamb", learning_rate=1e-3),
    # LAMB keeps fp32 moments whatever optimizer_state_dtype says, as optax's
    # lamb chain (scale_by_adam) does
    dict(optimizer="lamb", learning_rate=1e-3, optimizer_state_dtype="bfloat16"),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "defaults")
def test_three_updates_match_optax(trees, kwargs):
    got, want, state = _run_both(trees, **kwargs)
    _assert_close(got, want)
    assert int(state["count"]) == 3
    for moments in (state.get("mu", {}), state.get("nu", {})):
        assert all(m.dtype == torch.float32 for m in moments.values())


def test_lamb_bf16_moment_checkpoint_is_upcast(trees, tmp_path):
    """A LAMB state saved with bf16 moments (the port's earlier behaviour)
    loads into the fp32 moments of the current state instead of being
    refused."""
    from pixparse_tpu_torch.framework.checkpoint import _load_into

    jv, jb, params, _ = trees
    opt, _ = create_optimizer(
        OptimizationCfg(optimizer="lamb", optimizer_state_dtype="bfloat16"), **SCHED)
    template = opt.init(_to_port(params, jv, jb))
    old = {k: ({n: (t + 0.25).to(torch.bfloat16) for n, t in v.items()}
               if k in ("mu", "nu") else v.clone()) for k, v in template.items()}
    torch.save(old, tmp_path / "state.pt")
    saved = torch.load(tmp_path / "state.pt", weights_only=True)
    restored = _load_into(template, saved, "opt_state")
    for k in ("mu", "nu"):
        for n, t in restored[k].items():
            assert t.dtype == torch.float32
            assert torch.equal(t, saved[k][n].float()), n


def test_bf16_moments_match_jax(trees):
    got, want, state = _run_both(trees, optimizer_state_dtype="bfloat16")
    _assert_close(got, want, atol=2e-5)
    assert all(m.dtype == torch.bfloat16 for m in state["mu"].values())
    assert all(v.dtype == torch.bfloat16 for v in state["nu"].values())


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="optimizer"):
        create_optimizer(OptimizationCfg(optimizer="adagrad"), **SCHED)
    with pytest.raises(ValueError, match="clip_grad_mode"):
        create_optimizer(OptimizationCfg(clip_grad_value=1.0, clip_grad_mode="l1"), **SCHED)
    with pytest.raises(ValueError, match="scheduler"):
        create_scheduler(OptimizationCfg(scheduler="step"), **SCHED)
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        create_optimizer(OptimizationCfg(optimizer_state_dtype="int8"), **SCHED)
