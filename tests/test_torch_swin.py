"""The port's Swin encoder and the Swin Cruller against the JAX package's, on
the CPU in fp32.

- the helper arrays (relative-position index, shift mask, window partition
  and reverse) equal JAX's exactly;
- the encoder at ``swin_test`` (64x64) and at a two-stage ``SwinCfg`` whose
  maps need padding and shifted windows, within 1e-4;
- ``cruller_swin_test`` greedy tokens identical to JAX ``generate``;
- the JAX package's ``.pt`` export loads into the port strictly, and the
  port's export loads back into the JAX package.

Weights: a JAX init tree redrawn from a numpy seed, moved with the port's
``cruller_state_dict_from_jax``. Window attention runs its plain version on
the CPU; the CUDA kernel is held against it on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models import swin as jax_swin
from pixparse_tpu.models.torch_interop import cruller_params_from_torch, cruller_params_to_torch
from pixparse_tpu.ops.generation import generate as jax_generate
from pixparse_tpu_torch.models import swin
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import (
    _swin_from_jax,
    cruller_state_dict,
    cruller_state_dict_from_jax,
    load_cruller_state_dict,
)
from pixparse_tpu_torch.ops.generation import generate

VOCAB, PAD = 300, 1
TOL = dict(atol=1e-4, rtol=1e-4)
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "relative_position_bias_table": 0.5}


def redrawn(params, seed):
    """A JAX init tree with weights redrawn from a numpy seed (numpy leaves)."""
    rng = np.random.RandomState(seed)

    def redraw(path, x):
        std = SCALES.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    return jax.tree_util.tree_map_with_path(redraw, nn.unbox(params))


@pytest.mark.parametrize("window", [4, 7, 10, 12])
def test_rel_pos_index_matches_jax(window):
    np.testing.assert_array_equal(swin._rel_pos_index(window), jax_swin._rel_pos_index(window))


@pytest.mark.parametrize("h,w,window,shift", [(16, 16, 4, 2), (12, 16, 4, 2), (20, 30, 10, 5)])
def test_shift_mask_and_window_helpers_match_jax(h, w, window, shift):
    np.testing.assert_array_equal(
        swin._shift_attn_mask(h, w, window, shift), jax_swin._shift_attn_mask(h, w, window, shift)
    )
    x = np.random.RandomState(0).randn(2, h, w, 3).astype(np.float32)
    ref = np.asarray(jax_swin._window_partition(jnp.asarray(x), window))
    got = swin._window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = swin._window_reverse(got, window, 2, h, w)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_swin._window_reverse(jnp.asarray(ref), window, 2, h, w))
    )
    np.testing.assert_array_equal(back.numpy(), x)


PADDED = jax_swin.SwinCfg(
    img_size=(40, 56), patch_size=4, in_chans=3, embed_dim=32, depths=(2, 2),
    num_heads=(2, 4), window_size=4,
)


@pytest.mark.parametrize("name", ["swin_test", "padded_two_stage"])
def test_swin_encoder_matches_jax(name):
    """``padded_two_stage``: 10x14 then 5x7 maps under window 4, so every
    block pads, and the odd blocks of both stages shift by 2."""
    if name == "swin_test":
        jcfg, _ = jax_swin.resolve_swin_cfg("swin_test", (64, 64), 3)
        cfg, _ = swin.resolve_swin_cfg("swin_test", (64, 64), 3)
    else:
        jcfg = PADDED
        cfg = swin.SwinCfg(**{f: getattr(PADDED, f) for f in PADDED.__dataclass_fields__})
    rng = np.random.RandomState(1)
    img = rng.randn(2, *jcfg.img_size, 3).astype(np.float32)
    jm = jax_swin.Swin(jcfg)
    params = redrawn(jm.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"], seed=2)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(img)))

    sd = {}
    _swin_from_jax(sd, params, cfg, "")
    tm = swin.Swin(cfg)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(img))
    assert out.shape == ref.shape == (2, cfg.num_tokens, cfg.out_dim)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the fused-kernel path (plain on the CPU) gives the same encoding
    tm.attn_impl = "flash"
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(img)).numpy(), out.numpy(), atol=0, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_swin_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 1)), jnp.zeros((2, 4), jnp.int32))
    params = redrawn(init["params"], seed=0)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_swin_test"), vocab_size=VOCAB)
    tm = Cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    img = np.random.RandomState(3).randn(3, 64, 64, 1).astype(np.float32)
    return jm, params, tm.eval(), img


def test_cruller_swin_greedy_tokens_identical_to_jax(pair):
    jm, params, tm, img = pair
    prompt = np.array([[0, 5], [0, PAD], [0, 7]])
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(img))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    kw = dict(max_length=24, eos_token_id=2, pad_token_id=PAD)
    ref = jax_generate(jm, params, jenc, jnp.asarray(prompt, jnp.int32), **kw)
    out = generate(tm, tenc, torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(out.tokens[:, 2:].flatten().tolist())) > 3  # the weights shape the text


def test_pt_exports_load_both_ways(pair, tmp_path):
    jm, params, tm, img = pair
    sd = cruller_params_to_torch(params, jm.vit_cfg, jm.bart_cfg)
    assert set(sd) == set(tm.state_dict())
    path = tmp_path / "jax.pt"
    torch.save({k: torch.from_numpy(np.array(x)) for k, x in sd.items()}, path)
    other = Cruller(tm.vit_cfg, tm.bart_cfg)
    load_cruller_state_dict(other, torch.load(path, weights_only=True))
    txt = torch.from_numpy(np.random.RandomState(4).randint(3, VOCAB, (3, 9)))
    with torch.no_grad():
        a = other.eval()(torch.from_numpy(img), txt)
        ref = tm(torch.from_numpy(img), txt)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=0, rtol=0)

    # the port's export -> the JAX package: the same logits as the JAX tree
    back = cruller_params_from_torch(
        {k: v.numpy() for k, v in cruller_state_dict(tm).items()}, jm.vit_cfg, jm.bart_cfg
    )
    ref = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt.numpy(), jnp.int32))
    got = jm.apply({"params": back}, jnp.asarray(img), jnp.asarray(txt.numpy(), jnp.int32))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=0, rtol=0)


def test_swin_training_is_refused_and_pix2struct_is_not_ported():
    """A Swin Cruller's train setup builds the Swin model under the task's
    automatic remat mode (none at this size); the pix2struct encoder name
    resolves to its own cfg, ``image_size`` read as (max_patches,
    patch_size)."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_pretrain import (
        TaskCrullerPretrain,
        TaskCrullerPretrainCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_swin_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        device="cpu",
    )
    task = TaskCrullerPretrain(cfg, DeviceEnv.initialize("cpu"))
    task.train_setup(num_batches_per_interval=2)
    assert isinstance(task.model.encoder, swin.Swin) and task.model.remat is False
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_swin_test"), vocab_size=VOCAB)
    assert isinstance(v, swin.SwinCfg)
    from pixparse_tpu_torch.models.cruller import resolve_image_encoder_cfg

    from pixparse_tpu_torch.models.pix2struct import Pix2StructCfg

    cfg, stats = resolve_image_encoder_cfg("pix2struct_base", (64, 16), 1)
    assert isinstance(cfg, Pix2StructCfg)
    assert (cfg.max_patches, cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.max_rows) == (
        64, 16, 768, 12, 2048)
    assert stats == {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}
