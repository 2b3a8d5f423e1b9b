"""The port's remat modes (``models/remat.py``, ``resolve_remat``) against
no-remat and against the JAX package's, on the CPU in fp32.

- ``resolve_remat`` equals the JAX function for every flag value, and the
  task's automatic mode is none for cruller_base, ``'mlp'`` for donut_base
  and cruller_large (encoder tokens x depth over 20000);
- at ``cruller_test`` and ``cruller_swin_test`` with the decoder's dropout
  0.1 live, the loss and every gradient under each mode equal no-remat's
  within 1e-6: the recompute draws the forward's dropout masks (the dropout
  generator is replayed), and recomputing changes no value;
- with dropout 0 they equal JAX ``value_and_grad`` through its ``Cruller``
  at the same mode within 1e-5 (fp32, other summation order).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.task.cruller_base import resolve_remat as jax_resolve_remat
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.loss import cross_entropy_from_hidden
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask, resolve_remat

VOCAB = 200
MODES = (False, "gelu", "mlp", "dots", True)  # True = 'full'
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
FLAGS = (None, "auto", "none", "False", "0", "off", "true", "FULL", "1", "on", "dots", "mlp",
         "Gelu", True, False, 0, 1)


def auto_remat(vit_cfg):
    """The train task's automatic remat rule (``auto_remat``) for an encoder cfg."""
    return BaseCrullerTrainTask.auto_remat(SimpleNamespace(vit_cfg=vit_cfg))


@pytest.mark.parametrize("auto", [False, "mlp"])
def test_resolve_remat_matches_jax(auto):
    for flag in FLAGS:
        assert resolve_remat(flag, auto) == jax_resolve_remat(flag, auto), flag
    for bad in ("sometimes", "selective"):
        with pytest.raises(ValueError, match="unknown remat mode"):
            resolve_remat(bad, auto)
        with pytest.raises(ValueError, match="unknown remat mode"):
            jax_resolve_remat(bad, auto)


def test_auto_rule():
    cfg = lambda name: resolve_cruller_cfgs(get_model_config(name))[0]
    assert auto_remat(cfg("cruller_base")) is False
    assert auto_remat(cfg("donut_base")) == "mlp"
    # cruller_large's encoder (not in the port's registry yet): 2509 tokens x 24 blocks
    large, _, _ = jax_resolve(jax_model_config("cruller_large"))
    assert large.num_tokens * large.depth > 20000 and auto_remat(large) == "mlp"


def _batch(name, n=2, text_len=12, seed=0):
    v, _, _ = resolve_cruller_cfgs(get_model_config(name), vocab_size=VOCAB)
    rng = np.random.RandomState(seed)
    img = rng.randn(n, *v.img_size, v.in_chans).astype(np.float32)
    txt = rng.randint(4, VOCAB, size=(n, text_len)).astype(np.int32)
    tgt = np.roll(txt, -1, axis=1).astype(np.int32)
    tgt[:, -1] = -100
    return img, txt, tgt


def _port_loss_and_grads(model, img, txt, tgt, seed=123):
    model.decoder.dropout_generator.manual_seed(seed)
    if model.decoder.shard_dropout_generator is not None:
        model.decoder.shard_dropout_generator.manual_seed(seed + 1)
    hidden = model.forward_hidden(torch.from_numpy(img), torch.from_numpy(txt).long())
    loss, _ = cross_entropy_from_hidden(hidden, model.tied_embedding, torch.from_numpy(tgt).long())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("shard_stream", [False, True])
@pytest.mark.parametrize("name", ["cruller_test", "cruller_swin_test"])
def test_every_mode_equals_no_remat_with_dropout_live(name, shard_stream):
    """``shard_stream``: the activation dropout draws from its own generator
    (as a tensor-parallel rank's does): a region replays both streams."""
    v, b, _ = resolve_cruller_cfgs(get_model_config(name), vocab_size=VOCAB)
    assert b.dropout == b.activation_dropout == 0.1
    model = Cruller(v, b).init_weights(torch.Generator().manual_seed(0)).train()
    model.decoder.dropout_generator = torch.Generator()
    if shard_stream:
        model.decoder.shard_dropout_generator = torch.Generator()
    batch = _batch(name)
    ref_loss, ref = _port_loss_and_grads(model, *batch)
    _, other_seed = _port_loss_and_grads(model, *batch, seed=7)
    assert any((other_seed[k] - ref[k]).abs().max() > 1e-4 for k in ref)  # dropout is live
    for mode in MODES[1:]:
        model.remat = mode
        loss, grads = _port_loss_and_grads(model, *batch)
        assert abs(loss - ref_loss) <= 1e-6, mode
        for k, g in grads.items():
            torch.testing.assert_close(g, ref[k], atol=1e-6, rtol=1e-6, msg=f"{mode} {k}")


def _jax_pair(name):
    jv, jb, _ = jax_resolve(jax_model_config(name), vocab_size=VOCAB)
    jb = dataclasses.replace(jb, **NO_DROPOUT)
    img, txt, tgt = _batch(name)
    init = JaxCruller(jv, jb).init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(txt))
    params = jax.tree_util.tree_map(np.asarray, nn.unbox(init["params"]))
    v, b, _ = resolve_cruller_cfgs(get_model_config(name), vocab_size=VOCAB)
    b = dataclasses.replace(b, **NO_DROPOUT)
    model = Cruller(v, b).train()
    load_cruller_state_dict(model, cruller_state_dict_from_jax(params, v, b))
    model.decoder.dropout_generator = torch.Generator()
    return jv, jb, params, model, (img, txt, tgt)


@pytest.mark.parametrize("name", ["cruller_test", "cruller_swin_test"])
def test_every_mode_equals_jax_at_the_same_mode(name):
    jv, jb, params, model, batch = _jax_pair(name)
    img, txt, tgt = batch
    v, b = model.vit_cfg, model.bart_cfg
    for mode in MODES:
        jm = JaxCruller(jv, jb, remat=mode)

        def loss_fn(p):
            hidden = jm.apply({"params": p}, jnp.asarray(img), jnp.asarray(txt),
                              method="forward_hidden")
            emb = p["text_decoder"]["embed_tokens"]["embedding"]
            return jax_loss.cross_entropy_from_hidden(hidden, emb, jnp.asarray(tgt))[0]

        jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
        want = cruller_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jg), v, b, tied_head=False)
        model.remat = mode
        loss, grads = _port_loss_and_grads(model, *batch)
        assert abs(loss - float(jl)) < 1e-5, mode
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{mode} {k}")
