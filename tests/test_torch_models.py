"""The port's Cruller (ViT encoder + BART decoder) against the JAX package's,
on the CPU at the ``cruller_test`` size, fp32, atol 1e-4.

Weights: a JAX ``Cruller.init`` tree, perturbed from a numpy seed (larger
than the init scale, so every layer shapes the output), moved with
``cruller_state_dict_from_jax``; and separately the JAX package's own
``cruller_params_to_torch`` export, loaded strictly. Encoder attention
runs the plain path on the CPU; the CUDA kernels are held against their
plain versions only on the card (chip_smoke.py).
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
from pixparse_tpu.models.torch_interop import cruller_params_to_torch, resize_token_embeddings
from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import (
    cruller_state_dict_from_jax,
    load_cruller_state_dict,
)

VOCAB = 512
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_params(model, batch, seed=0):
    """JAX init tree with weights redrawn from a numpy seed (numpy leaves)."""
    rng = np.random.RandomState(seed)
    img = jnp.zeros((batch, *model.vit_cfg.img_size, 1))
    params = nn.unbox(model.init(jax.random.PRNGKey(0), img, jnp.zeros((batch, 4), jnp.int32)))
    scales = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}

    def redraw(path, x):
        std = scales.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    return jax.tree_util.tree_map_with_path(redraw, params["params"])


@pytest.fixture(scope="module")
def pair():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb)
    params = jax_params(jm, batch=3)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
    tm = Cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    rng = np.random.RandomState(1)
    img = rng.randn(3, 64, 48, 1).astype(np.float32)
    txt = rng.randint(3, VOCAB, (3, 12)).astype(np.int64)
    return jm, params, tm.eval(), img, txt


def test_encode_matches_jax(pair):
    jm, params, tm, img, _ = pair
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(img), method="encode"))
    with torch.no_grad():
        out = tm.encode(torch.from_numpy(img)).numpy()
    assert out.shape == (3, 13, 64)
    np.testing.assert_allclose(out, ref, **TOL)


def test_train_mode_logits_match_jax(pair):
    jm, params, tm, img, txt = pair
    mask = np.ones_like(txt)
    mask[1, 8:] = 0  # right padding
    ref = np.asarray(jm.apply(
        {"params": params}, jnp.asarray(img), jnp.asarray(txt, jnp.int32),
        attention_mask=jnp.asarray(mask),
    ))
    with torch.no_grad():
        out = tm(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (3, 12, VOCAB)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_prefill_and_decode_steps_match_jax(pair):
    """Prefill 4 prompt tokens, then 3 cached single-token steps: logits
    match the JAX cached decode step by step."""
    jm, params, tm, img, txt = pair
    T = 32
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(img))
    dm = jm.clone(max_cache_len=T)
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: dm.init(
            jax.random.PRNGKey(0), jnp.asarray(txt[:, :4], jnp.int32), jenc,
            mode="prefill", method="decode",
        )["cache"]),
    )
    cache = KVCache(max_len=T)
    key_mask = np.zeros((3, T), bool)
    for i, mode in [(slice(0, 4), "prefill"), (slice(4, 5), "decode"),
                    (slice(5, 6), "decode"), (slice(6, 7), "decode")]:
        key_mask[:, i] = True
        key_mask[2, 1] = False  # a pad hole in one row's prompt keys
        ref, mut = dm.apply(
            {"params": params, "cache": jcache}, jnp.asarray(txt[:, i], jnp.int32), jenc,
            key_pad_mask=jnp.asarray(key_mask), mode=mode, method="decode", mutable=["cache"],
        )
        jcache = mut["cache"]
        with torch.no_grad():
            out = tm.decode(
                torch.from_numpy(txt[:, i]), tenc, cache,
                key_pad_mask=torch.from_numpy(key_mask), mode=mode,
            )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert cache.index == 7 and cache.self_k[0].shape == (3, 128, 64)
    assert cache.cross_k[0].shape == (3, 128, 64) and cache.cross_mask.shape == (3, 128)


def test_reference_export_loads_strictly(pair, tmp_path):
    """A ``.pt`` written from the JAX package's ``cruller_params_to_torch``
    loads into the port with strict names and gives the same logits."""
    jm, params, tm, img, txt = pair
    v, b = tm.vit_cfg, tm.bart_cfg
    sd = cruller_params_to_torch(params, jm.vit_cfg, jm.bart_cfg)
    path = tmp_path / "ckpt.pt"
    torch.save({k: torch.from_numpy(np.array(x)) for k, x in sd.items()}, path)
    assert set(sd) == set(tm.state_dict())
    other = Cruller(v, b)
    load_cruller_state_dict(other, torch.load(path, weights_only=True))
    with torch.no_grad():
        a = other.eval()(torch.from_numpy(img), torch.from_numpy(txt))
        ref = tm(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=0, rtol=0)
    # the tied head may be absent from a checkpoint
    del sd["text_decoder.trunk.lm_head.weight"]
    load_cruller_state_dict(Cruller(v, b), sd)


def test_vocab_mismatch_and_unported_modes_raise(pair):
    """A checkpoint 2 rows short of the model's vocab loads with its tied
    table resized exactly as the JAX package's import resizes it (the
    vocab-resize replay); the unported decode modes raise."""
    _, params, tm, _, _ = pair
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB + 2)
    grown = Cruller(v, b)
    load_cruller_state_dict(grown, tm.state_dict())
    want = resize_token_embeddings(params["text_decoder"], VOCAB + 2)["embed_tokens"]["embedding"]
    np.testing.assert_array_equal(grown.tied_embedding.detach().numpy(), np.asarray(want))
    assert grown.decoder.lm_head.weight is grown.decoder.model.decoder.embed_tokens.weight
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        Cruller(v, b, kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="lm_head_dtype"):
        Cruller(v, b, lm_head_dtype="fp8")
