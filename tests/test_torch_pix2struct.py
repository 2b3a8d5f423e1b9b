"""The port's pix2struct pieces against the JAX package's, on the CPU, fp32,
plain attention: ``variable_grid``, the host and device patchify, the
encoder on a batch whose samples hold different numbers of real patches,
the whole ``Pix2StructCruller`` (logits, ``forward_hidden``, the step-1 loss
through ``cross_entropy_from_hidden`` and every parameter's gradient), greedy
decode with the encoder's pad mask, and the routing of the flash path (every
encoder block and every decoder cross site reaches flash with ``kv_lens``).

Weights: a JAX init tree redrawn from a numpy seed, moved with
``cruller_state_dict_from_jax``. Tolerances: forward 1e-4, loss and
gradients 5e-4 (abs and rel).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models.pix2struct import Pix2StructCruller as JaxP2S
from pixparse_tpu.models.pix2struct import Pix2StructEncoder as JaxEncoder
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.ops import pix2struct as jops
from pixparse_tpu.ops.generation import generate as jax_generate
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import create_cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.models.pix2struct import (
    Pix2StructCfg,
    Pix2StructCruller,
    Pix2StructEncoder,
    mask_lens,
)
from pixparse_tpu_torch.ops import loss as tloss
from pixparse_tpu_torch.ops import pix2struct as tops
from pixparse_tpu_torch.ops.generation import generate

VOCAB = 512
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "scale": None}


def redraw(params, seed=0):
    """JAX init tree with dense kernels, biases and tables redrawn from a
    numpy seed (numpy leaves)."""
    rng = np.random.RandomState(seed)

    def one(path, x):
        std = SCALES.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    return jax.tree_util.tree_map_with_path(one, nn.unbox(params))


def pages(n_patches, sizes, seed=1):
    """Host-patchified pages of the given (h, w), stacked: the JAX and the
    port's patchify agree bit for bit, so either makes the batch."""
    rng = np.random.RandomState(seed)
    out = [tops.patchify_variable(rng.randint(0, 255, (h, w), np.uint8), 16, n_patches)
           for h, w in sizes]
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


# --------------------------------------------------------------------- ops

@pytest.mark.parametrize("hw", [(1700, 1300), (600, 800), (3508, 2480), (4000, 300), (452, 4),
                                (16, 16), (300, 4000), (1, 1), (97, 23)])
@pytest.mark.parametrize("budget", [64, 2048])
def test_variable_grid_equals_jax(hw, budget):
    got = tops.variable_grid(*hw, 16, budget)
    assert got == jops.variable_grid(*hw, 16, budget)
    assert got[0] * got[1] <= budget and min(got) >= 1


@pytest.mark.parametrize("shape,dtype", [
    ((300, 200), np.uint8), ((300, 200, 1), np.uint8), ((90, 140, 3), np.uint8),
    ((4000, 30), np.uint8), ((45, 4), np.uint8), ((120, 90), np.float32),
    ((64, 48, 3), np.float64),
])
def test_host_patchify_is_bit_for_bit_jax(monkeypatch, shape, dtype):
    """Both sides on PIL's bilinear resize: the JAX one's native resizer and
    the port's are made to report themselves unavailable for the test (with
    both libraries built, both take the same native resize:
    tests/test_torch_native.py)."""
    import pixparse_tpu.native as native

    monkeypatch.setattr(native, "resize_bilinear", lambda *a, **k: None)
    monkeypatch.setattr(tops, "resize_bilinear", lambda *a, **k: None)
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 255, shape).astype(dtype)
    if dtype != np.uint8 and shape[0] == 120:
        img = img / 255.0  # a [0, 1] float page
    c = 1 if len(shape) == 2 else shape[2]
    kw = dict(mean=(0.5,) * c, std=(0.5,) * c)
    want = jops.patchify_variable(img, 16, 256, **kw)
    got = tops.patchify_variable(img, 16, 256, **kw)
    for k in ("patches", "rows", "cols", "mask"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = int(got["mask"].sum())
    assert (got["patches"][n:] == 0).all() and got["mask"][:n].all()


@pytest.mark.parametrize("hw,budget,c", [
    ((128, 96), 64, 1),  # down
    ((37, 53), 64, 1),  # up, non-integer ratios
    ((250, 40), 32, 3),  # extreme aspect, down
    ((61, 61), 16, 1),  # 4 x 4 grid of 16 -> 64 px: up by 64/61
    ((300, 200), 2048, 1),  # up 2x-ish to a large grid
])
def test_device_patchify_within_1e5_of_jax(hw, budget, c):
    rng = np.random.RandomState(hw[0])
    imgs = rng.uniform(-1, 1, (2, *hw, c)).astype(np.float32)
    want = jops.patchify_variable_batch(jnp.asarray(imgs), 16, budget)
    got = tops.patchify_variable_batch(torch.from_numpy(imgs), 16, budget)
    np.testing.assert_allclose(got["patches"].numpy(), np.asarray(want["patches"]), atol=1e-5,
                               rtol=1e-5)
    for k in ("rows", "cols", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["rows"].dtype == torch.int32 and got["mask"].dtype == torch.bool


# ----------------------------------------------------------------- encoder

ENC_CFG = dict(max_patches=64, patch_size=16, in_chans=1, embed_dim=32, depth=2, num_heads=2,
               max_rows=32, max_cols=32)
SIZES = [(120, 90), (40, 300), (200, 60)]  # different numbers of real patches


def test_encoder_equals_jax_with_ragged_valid_counts():
    from pixparse_tpu.models.pix2struct import Pix2StructCfg as JaxCfg

    batch = pages(64, SIZES)
    counts = batch["mask"].sum(-1)
    assert len(set(counts.tolist())) == 3
    jm = JaxEncoder(JaxCfg(**ENC_CFG))
    jb = [jnp.asarray(batch[k]) for k in ("patches", "rows", "cols", "mask")]
    params = redraw(jm.init(jax.random.PRNGKey(0), *jb)["params"])
    want = np.asarray(jm.apply({"params": params}, *jb))

    cfg = Pix2StructCfg(**ENC_CFG)
    tm = Pix2StructEncoder(cfg)
    sd = {}
    from pixparse_tpu_torch.models.interop import _pix2struct_from_jax

    _pix2struct_from_jax(sd, params, cfg, "")
    tm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(batch[k]) for k in ("patches", "rows", "cols", "mask")))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, n in enumerate(counts):
        assert (got[b, n:] == 0).all() and got[b, :n].abs().max() > 0
    # the pad patches' content does not reach the real tokens
    batch2 = dict(batch, patches=np.where(batch["mask"][..., None], batch["patches"], 123.0))
    with torch.no_grad():
        got2 = tm(*(torch.from_numpy(np.asarray(batch2[k])) for k in ("patches", "rows", "cols",
                                                                        "mask")))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def pair():
    jv, jb, _ = jax_resolve(jax_model_config("pix2struct_test"), vocab_size=VOCAB)
    jm = JaxP2S(jv, jb)
    batch = pages(jv.max_patches, SIZES)
    rng = np.random.RandomState(2)
    txt = rng.randint(3, VOCAB, (3, 12)).astype(np.int64)
    image = {k: jnp.asarray(v) for k, v in batch.items()}
    params = redraw(jm.init(jax.random.PRNGKey(0), image, jnp.asarray(txt, jnp.int32))["params"])
    v, b, _ = resolve_cruller_cfgs(get_model_config("pix2struct_test"), vocab_size=VOCAB)
    tm = create_cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    return jm, params, tm.eval(), batch, txt


def timage(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_model_dispatch_and_state_dict(pair):
    jm, params, tm, _, _ = pair
    assert isinstance(tm, Pix2StructCruller) and isinstance(tm.vit_cfg, Pix2StructCfg)
    grads = cruller_state_dict_from_jax(params, tm.vit_cfg, tm.bart_cfg, tied_head=False)
    assert set(grads) == {n for n, _ in tm.named_parameters()}
    assert tm.encoder.row_embed.weight.shape == (64, 64)


def test_logits_and_hidden_equal_jax(pair):
    jm, params, tm, batch, txt = pair
    image = {k: jnp.asarray(v) for k, v in batch.items()}
    mask = np.ones_like(txt)
    mask[1, 8:] = 0
    want = np.asarray(jm.apply({"params": params}, image, jnp.asarray(txt, jnp.int32),
                               attention_mask=jnp.asarray(mask)))
    want_h = np.asarray(jm.apply({"params": params}, image, jnp.asarray(txt, jnp.int32),
                                 method="forward_hidden"))
    want_enc = np.asarray(jm.apply({"params": params}, image, method="encode"))
    with torch.no_grad():
        got = tm(timage(batch), torch.from_numpy(txt), attention_mask=torch.from_numpy(mask))
        got_h = tm.forward_hidden(timage(batch), torch.from_numpy(txt))
        got_enc = tm.encode(timage(batch))
    np.testing.assert_allclose(got_enc.numpy(), want_enc, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_h.numpy(), want_h, **TOL)


def test_step_one_loss_and_every_gradient_equal_jax(pair):
    jm, params, tm, batch, txt = pair
    image = {k: jnp.asarray(v) for k, v in batch.items()}
    target = np.roll(txt, -1, axis=1)
    target[:, -1] = -100
    target[2, 5:] = -100

    def jax_loss_fn(p):
        hidden = jm.apply({"params": p}, image, jnp.asarray(txt, jnp.int32),
                          method="forward_hidden")
        emb = p["text_decoder"]["embed_tokens"]["embedding"].astype(hidden.dtype)
        return jax_loss.cross_entropy_from_hidden(hidden, emb, jnp.asarray(target))[0]

    jl, jgrads = jax.value_and_grad(jax_loss_fn)(params)
    want = cruller_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tm.vit_cfg,
                                       tm.bart_cfg, tied_head=False)
    named = dict(tm.named_parameters())
    hidden = tm.forward_hidden(timage(batch), torch.from_numpy(txt))
    loss, _ = tloss.cross_entropy_from_hidden(hidden, tm.tied_embedding, torch.from_numpy(target))
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **GRAD_TOL)
    assert set(named) == set(want)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_greedy_decode_with_the_pad_mask_equals_jax(pair):
    jm, params, tm, batch, _ = pair
    image = {k: jnp.asarray(v) for k, v in batch.items()}
    enc = jm.apply({"params": params}, image, method="encode")
    prompt = np.array([[0], [0], [0]], np.int32)
    kw = dict(max_length=16, eos_token_id=2, pad_token_id=1)
    want = jax_generate(jm, params, enc, jnp.asarray(prompt),
                        encoder_pad_mask=jnp.asarray(batch["mask"]), **kw)
    with torch.no_grad():
        tenc = tm.encode(timage(batch))
    got = generate(tm, tenc, torch.from_numpy(prompt).long(),
                   encoder_pad_mask=torch.from_numpy(batch["mask"]), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("remat", [True, "dots", "mlp", "gelu"])
def test_remat_modes_keep_the_kv_lens(pair, remat):
    """Under each remat mode (the encoder blocks checkpointed whole under
    full/dots) the loss and gradients equal the un-rematerialized ones."""
    _, _, tm, batch, txt = pair

    def loss_and_grads():
        hidden = tm.forward_hidden(timage(batch), torch.from_numpy(txt))
        loss = tloss.cross_entropy_from_hidden(hidden, tm.tied_embedding,
                                               torch.from_numpy(txt))[0]
        return loss, torch.autograd.grad(loss, list(tm.parameters()))

    tm.remat = False
    want = loss_and_grads()
    tm.remat = remat
    try:
        got = loss_and_grads()
    finally:
        tm.remat = False
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=1e-6)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_flash_route_reaches_every_encoder_block_and_cross_site(pair, monkeypatch, caplog):
    """With ``attn_impl='flash'`` in train mode, each encoder block and each
    decoder cross-attention calls flash with the batch's valid counts (the
    flash function replaced by a counting plain version), the decoder's
    self-attention calls it without, and nothing falls back to a bias."""
    import pixparse_tpu_torch.ops.flash_attention as fa

    _, _, tm, batch, txt = pair
    calls = []
    plain = fa.flash_attention_plain

    def counting(q, k, v, causal=False, kv_lens=None):
        calls.append((q.shape[1], k.shape[1], causal,
                      None if kv_lens is None else kv_lens.tolist()))
        return plain(q, k, v, causal=causal, kv_lens=kv_lens)[0]

    monkeypatch.setattr(fa, "flash_attention", counting)
    tm.attn_impl = "flash"
    try:
        with caplog.at_level(logging.WARNING), torch.no_grad():
            flash = tm.forward_hidden(timage(batch), torch.from_numpy(txt))
        tm.attn_impl = "xla"
        with torch.no_grad():
            ref = tm.forward_hidden(timage(batch), torch.from_numpy(txt))
    finally:
        tm.attn_impl = "xla"
    lens = batch["mask"].sum(-1).tolist()
    N, L = batch["mask"].shape[1], txt.shape[1]
    depth, layers = tm.vit_cfg.depth, tm.bart_cfg.decoder_layers
    assert calls.count((N, N, False, lens)) == depth
    assert calls.count((L, N, False, lens)) == layers
    assert calls.count((L, L, True, None)) == layers
    assert len(calls) == depth + 2 * layers
    assert "forces the plain" not in caplog.text
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), **TOL)


def test_mask_lens_counts_real_patches():
    mask = torch.tensor([[True, True, False], [True, False, False]])
    assert mask_lens(mask).tolist() == [2, 1] and mask_lens(mask).dtype == torch.int32
    assert mask_lens(None) is None
