"""The port's int8 decode mode against the JAX package's, on the CPU.

- ``quantize_int8_rows`` / ``quantize_kv_rows`` bit-equal to JAX's (the
  port keeps the scales ``(B, H, L)``; JAX pads the heads to 8 rows);
- ``decode_attention_q8`` (plain version on the CPU) against JAX's Pallas
  kernel in interpret mode, fp32 within 1e-5, with ragged and dead rows;
- greedy tokens of ``cruller_test`` with ``kv_cache_dtype='int8'`` and
  ``lm_head_dtype='int8'`` identical to the JAX package's int8 mode;
- the int8 mode's prefill (exact projections), single-token steps (int8
  kernel) and a multi-token step (dequantized caches) match JAX's logits.

The CUDA kernel is held against the plain version on the card.
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
from pixparse_tpu.ops import decode_attention as jax_da
from pixparse_tpu.ops.generation import generate as jax_generate
from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.decode_attention import (
    decode_attention_q8,
    quantize_int8_rows,
    quantize_kv_rows,
)
from pixparse_tpu_torch.ops.generation import generate

VOCAB, PAD = 512, 1


def test_quantizers_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 40, 6 * 16) * 3).astype(np.float32)
    x[0, 5] = 0.0  # an all-zero row: scale 1
    x[1, 2, :16] = 0.0  # one zero head row
    ref_i8, ref_s = jax_da.quantize_int8_rows(jnp.asarray(x), axis=-1)
    got_i8, got_s = quantize_int8_rows(torch.from_numpy(x), -1)
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(ref_i8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    ref_i8, ref_s = jax_da.quantize_kv_rows(jnp.asarray(x), 6)
    got_i8, got_s = quantize_kv_rows(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(ref_i8))
    assert got_s.shape == (3, 6, 40) and ref_s.shape == (3, 8, 40)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s)[:, :6])
    # half-to-even rounding, as jnp.round
    halves = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    np.testing.assert_array_equal(
        quantize_int8_rows(halves, -1)[0].numpy(),
        np.asarray(jax_da.quantize_int8_rows(jnp.asarray(halves.numpy()), axis=-1)[0]),
    )


@pytest.mark.parametrize("H,D", [(2, 32), (4, 64)])
def test_decode_attention_q8_matches_jax(H, D):
    B, Lk = 4, 256
    rng = np.random.RandomState(H * D)
    q = rng.randn(B, 1, H * D).astype(np.float32)
    k_i8, ks = jax_da.quantize_kv_rows(jnp.asarray(rng.randn(B, Lk, H * D).astype(np.float32)), H)
    v_i8, vs = jax_da.quantize_kv_rows(jnp.asarray(rng.randn(B, Lk, H * D).astype(np.float32)), H)
    mask = rng.rand(B, Lk) > 0.3
    mask[1] = False  # a dead row
    mask[2, 100:] = False  # ragged: a short prefix
    ref = jax_da.decode_attention_q8(
        jnp.asarray(q), k_i8, v_i8, ks, vs, jnp.asarray(mask), num_heads=H, interpret=True
    )
    out = decode_attention_q8(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (k_i8, v_i8, ks, vs)),
        torch.from_numpy(mask), num_heads=H,
    )
    assert out.shape == (B, 1, H * D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert (out[1] == 0).all()


@pytest.fixture(scope="module")
def int8_pair():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb, kv_cache_dtype="int8", lm_head_dtype="int8")
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 64, 48, 1)), jnp.zeros((4, 4), jnp.int32)
    ))["params"]
    scales = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}

    def redraw(path, x):
        std = scales.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    params = jax.tree_util.tree_map_with_path(redraw, init)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
    tm = Cruller(v, b, kv_cache_dtype="int8", lm_head_dtype="int8")
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    img = rng.randn(4, 64, 48, 1).astype(np.float32)
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.eval().encode(torch.from_numpy(img))
    return jm, params, jenc, tm, tenc


def test_int8_mode_greedy_tokens_identical_to_jax(int8_pair):
    jm, params, jenc, tm, tenc = int8_pair
    prompt = np.array([[0, 5, PAD], [0, PAD, PAD], [0, 7, 9], [0, 3, PAD]])
    kw = dict(max_length=20, eos_token_id=2, pad_token_id=PAD)
    ref = jax_generate(jm, params, jenc, jnp.asarray(prompt, jnp.int32), **kw)
    out = generate(tm, tenc, torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert len(set(out.tokens[:, 3:].flatten().tolist())) > 3
    # the cross caches are int8 with (B, H, Lk_pad) scales, padded with 1
    cache = KVCache(max_len=8)
    with torch.no_grad():
        tm.decode(torch.from_numpy(prompt), tenc, cache, mode="prefill")
    assert cache.cross_k[0].dtype == torch.int8 and cache.cross_k[0].shape == (4, 128, 64)
    assert cache.cross_v_scale[0].shape == (4, 2, 128) and (cache.cross_v_scale[0][:, :, 13:] == 1).all()


def test_int8_cache_steps_match_jax(int8_pair):
    """Prefill 3 tokens, two single-token steps, then one 2-token step: the
    logits of every call match the JAX int8 mode's (fp32, 1e-4)."""
    jm, params, jenc, tm, tenc = int8_pair
    T = 16
    txt = np.random.RandomState(5).randint(3, VOCAB, (4, 7))
    dm = jm.clone(max_cache_len=T)
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: dm.init(
            jax.random.PRNGKey(0), jnp.asarray(txt[:, :3], jnp.int32), jenc,
            mode="prefill", method="decode",
        )["cache"]),
    )
    cache = KVCache(max_len=T)
    key_mask = np.zeros((4, T), bool)
    for i, mode in [(slice(0, 3), "prefill"), (slice(3, 4), "decode"), (slice(4, 5), "decode"),
                    (slice(5, 7), "decode")]:
        key_mask[:, i] = True
        ref, mut = dm.apply(
            {"params": params, "cache": jcache}, jnp.asarray(txt[:, i], jnp.int32), jenc,
            key_pad_mask=jnp.asarray(key_mask), mode=mode, method="decode", mutable=["cache"],
        )
        jcache = mut["cache"]
        with torch.no_grad():
            out = tm.decode(
                torch.from_numpy(txt[:, i]), tenc, cache, key_pad_mask=torch.from_numpy(key_mask),
                mode=mode,
            )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
