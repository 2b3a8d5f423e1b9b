"""The int8 decode kernel's work split, on the CPU.

- ``decode_plan_q8`` (pure Python): tiles of whole keys within 16 KB,
  splits of whole tiles that cover ``Lk`` and fit the kernel's shared
  memory, a grid that is one resident wave at the given occupancy, every
  sample in a slot; a split no wave can hold raises.
- ``decode_attention_q8_plain(..., split_keys=...)``, the plain version that
  merges the softmax over the kernel's splits, against the JAX package's
  int8 kernel (Pallas, interpret mode) and the exact attention on the
  unquantized caches, with the bounds of ``tests/test_decode_attention.py``
  (max error < 0.05, mean < 0.01); and greedy tokens of ``cruller_test``
  in the int8 mode identical to the JAX package's with the port's decode
  attention merging over splits.

The CUDA kernel is held against this plain version on the card
(``tests/test_torch_kernels.py``, chip_smoke.py).
"""

import math

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
from pixparse_tpu_torch.models import bart as torch_bart
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops import decode_attention as da
from pixparse_tpu_torch.ops.generation import generate

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("B,Lk,H,D,blocks_per_sm", [
    (16, 1024, 12, 64, 2),  # cruller_base's cross cache (eval, int8)
    (8, 4864, 16, 64, 2),  # donut_base's
    (1, 32768, 12, 64, 2), (1, 32768, 16, 64, 2), (1, 32768, 24, 32, 2),  # the longest cache
    (1, 16384, 16, 64, 1),
    (64, 1024, 12, 64, 2), (333, 1024, 12, 64, 2), (333, 1024, 12, 64, 1),  # more samples than a wave
    (3, 256, 2, 32, 2), (4, 384, 12, 64, 1), (16, 1, 12, 64, 2), (1, 997, 6, 128, 2),
    (5, 4864, 8, 128, 1),
])
def test_decode_plan_q8(B, Lk, H, D, blocks_per_sm):
    kt, split, n_split, slots = da.decode_plan_q8(B, Lk, H, D, SMS, blocks_per_sm)
    HD = H * D
    assert kt == 4 * (256 // (HD // 16)) and kt * HD <= da.Q8_TILE_BYTES
    assert split % kt == 0 and (13 * H + 1) * split <= da.Q8_REGION_BYTES
    assert (n_split - 1) * split < Lk <= n_split * split
    assert n_split * slots <= SMS * blocks_per_sm  # co-resident
    assert 1 <= slots <= B and n_split <= da.Q8_MAX_SPLITS
    rounds = math.ceil(B / slots)
    assert (rounds - 1) * slots < B  # no round is empty


def test_decode_plan_q8_main_path():
    """About two blocks per SM at the two cross caches."""
    assert da.decode_plan_q8(16, 1024, 12, 64, SMS, 2) == (20, 80, 13, 16)
    assert da.decode_plan_q8(8, 4864, 16, 64, SMS, 2) == (16, 160, 31, 8)
    assert da.decode_plan_q8(64, 1024, 12, 64, SMS, 2) == (20, 260, 4, 64)


def test_decode_q8_takes_a_block_per_head_where_they_fill_the_card():
    assert da.decode_q8_by_heads(16, 1024, 12, SMS)  # cruller_base's cross cache
    assert da.decode_q8_by_heads(16, 2048, 12, SMS)
    assert not da.decode_q8_by_heads(8, 4864, 16, SMS)  # donut_base's: long rows
    assert not da.decode_q8_by_heads(16, 4864, 16, SMS)
    assert not da.decode_q8_by_heads(4, 1024, 12, SMS)  # 48 blocks on 132 SMs
    assert not da.decode_q8_by_heads(1, 128, 12, SMS)


def test_decode_plan_q8_raises_where_no_wave_holds_a_sample():
    with pytest.raises(ValueError, match="resident wave"):
        da.decode_plan_q8(1, 32768, 32, 32, SMS, 2)
    with pytest.raises(ValueError, match="rows of"):
        da.decode_plan_q8(1, 64, 64, 128, SMS, 2)


def _exact(q, k, v, mask, H):
    B, _, HD = q.shape
    D = HD // H
    s = np.einsum("bhd,bkhd->bhk", q.reshape(B, H, D), k.reshape(B, -1, H, D)) * D ** -0.5
    s = np.where(mask[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhk,bkhd->bhd", p, v.reshape(B, -1, H, D)).reshape(B, 1, HD)


@pytest.mark.parametrize("split_keys", ["plan", 100, 1009])
def test_split_plain_matches_jax(split_keys):
    B, Lk, H, D = 3, 1009, 4, 64
    rng = np.random.RandomState(13)
    q = rng.randn(B, 1, H * D).astype(np.float32)
    k = rng.randn(B, Lk, H * D).astype(np.float32)
    v = rng.randn(B, Lk, H * D).astype(np.float32)
    mask = np.ones((B, Lk), bool)
    mask[1, 700:] = False
    k_i8, ks = jax_da.quantize_kv_rows(jnp.asarray(k), H)
    v_i8, vs = jax_da.quantize_kv_rows(jnp.asarray(v), H)
    ref = np.asarray(jax_da.decode_attention_q8(
        jnp.asarray(q), k_i8, v_i8, ks, vs, jnp.asarray(mask), num_heads=H, interpret=True))
    if split_keys == "plan":
        split_keys = da.decode_plan_q8(B, Lk, H, D, SMS, 2)[1]
        assert -(-Lk // split_keys) > 1
    out = da.decode_attention_q8_plain(
        torch.from_numpy(q), *(torch.from_numpy(np.array(t)) for t in (k_i8, v_i8, ks, vs)),
        torch.from_numpy(mask), num_heads=H, split_keys=split_keys,
    ).numpy()
    assert np.abs(out - ref).max() < 0.05
    err = np.abs(out - _exact(q, k, v, mask, H))
    assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())


def test_split_plain_dead_rows_and_last_split_only():
    """A dead row gives 0; a row whose valid keys all lie in its last split
    gives what the unsplit plain version gives (one split holds its whole
    softmax), and a split with no valid key adds nothing to the merge."""
    B, Lk, H, D, split = 3, 300, 2, 32, 64
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, H * D, generator=g)
    k_i8, ks = da.quantize_kv_rows(torch.randn(B, Lk, H * D, generator=g), H)
    v_i8, vs = da.quantize_kv_rows(torch.randn(B, Lk, H * D, generator=g), H)
    mask = torch.rand(B, Lk, generator=g) > 0.3
    mask[1] = False
    mask[2, :4 * split] = False
    args = (q, k_i8, v_i8, ks, vs, mask)
    out = da.decode_attention_q8_plain(*args, num_heads=H, split_keys=split)
    ref = da.decode_attention_q8_plain(*args, num_heads=H)
    assert (out[1] == 0).all()
    torch.testing.assert_close(out[2], ref[2], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)


VOCAB, PAD = 512, 1


def test_int8_greedy_tokens_with_split_merge_identical_to_jax(monkeypatch):
    """Greedy tokens of ``cruller_test`` in the int8 mode, the port's decode
    attention merging each head's softmax over splits of 4 keys (its 13
    encoder tokens in 4 splits; the kernel's tiles at this width are 256
    keys, so its plan would take one), equal the JAX package's int8
    tokens."""
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

    splits = []

    def split_q8(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads):
        splits.append(int(mask.reshape(mask.shape[0], -1, 4).any(-1).sum(-1).max()))
        return da.decode_attention_q8_plain(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads,
                                            split_keys=4)

    monkeypatch.setattr(torch_bart, "decode_attention_q8", split_q8)
    prompt = np.array([[0, 5, PAD], [0, PAD, PAD], [0, 7, 9], [0, 3, PAD]])
    kw = dict(max_length=20, eos_token_id=2, pad_token_id=PAD)
    ref = jax_generate(jm, params, jenc, jnp.asarray(prompt, jnp.int32), **kw)
    out = generate(tm, tenc, torch.from_numpy(prompt), **kw)
    assert splits and min(splits) > 1  # every step merged several splits with valid keys
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
