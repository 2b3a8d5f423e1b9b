"""The port's attention functions against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function and the
port's plain PyTorch version, fp32, tolerance 2e-5 (as
tests/test_decode_attention.py). JAX's Pallas kernels run in interpret
mode, as the JAX tests run them on the CPU. The port's CUDA kernels are
held against these plain versions only on the card: by chip_smoke.py at
the serving path's shapes, and by tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.attention import dot_product_attention as jax_dpa
from pixparse_tpu.ops.decode_attention import _decode_attention_local
from pixparse_tpu.ops.flash_attention import flash_attention as jax_flash
from pixparse_tpu_torch.ops.attention import dot_product_attention
from pixparse_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from pixparse_tpu_torch.ops.flash_attention import (
    DEAD_LSE,
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B, Lq, Lk, H, D, seed):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, Lq, H, D).astype(np.float32),
        rng.randn(B, Lk, H, D).astype(np.float32),
        rng.randn(B, Lk, H, D).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "Lq,Lk,causal",
    [(100, 100, False), (160, 160, True), (32, 96, True), (64, 256, False)],
)
def test_plain_flash_matches_jax(Lq, Lk, causal):
    q, k, v = _qkv(2, Lq, Lk, 2, 32, seed=Lq + Lk)
    ref_flash = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    ref_xla = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out = flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref_flash, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)


def test_plain_flash_kv_lens_zero_row_gives_zeros():
    B, L, H, D = 4, 37, 2, 32
    q, k, v = _qkv(B, L, L, H, D, seed=3)
    lens = np.array([37, 0, 5, 20], np.int32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens)))
    o, lse = flash_attention_fwd(*_t(q, k, v), kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), ref, **TOL)
    assert (o[1] == 0).all() and (lse[1] == DEAD_LSE).all()
    # causal + kv_lens with Lq == Lk is allowed
    ref_c = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, kv_lens=jnp.asarray(lens)
    ))
    out_c = flash_attention(*_t(q, k, v), causal=True, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out_c.numpy(), ref_c, **TOL)


def test_plain_flash_lse_is_logsumexp():
    q, k, v = _qkv(2, 20, 30, 2, 32, seed=4)
    _, lse = flash_attention_plain(*_t(q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", *_t(q, k)) * 32 ** -0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), **TOL)


def test_flash_causal_kv_lens_unequal_lengths_raises():
    q, k, v = _qkv(1, 8, 16, 2, 32, seed=5)
    lens = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError, match="Lq == Lk"):
        flash_attention(*_t(q, k, v), causal=True, kv_lens=lens)
    with pytest.raises(ValueError, match="Lq == Lk"):
        jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, kv_lens=jnp.asarray(lens.numpy()))


@pytest.mark.parametrize("case", ["bias", "kv_lens", "causal"])
def test_dot_product_attention_matches_jax(case):
    """The plain path, including finfo.min semantics for fully masked rows
    (uniform average of v, as XLA gives)."""
    B, L, H, D = 3, 9, 2, 8
    q, k, v = _qkv(B, L, L, H, D, seed=6)
    rng = np.random.RandomState(6)
    kw_j, kw_t = {}, {}
    if case == "bias":
        mask = rng.rand(B, 1, L, L) > 0.3
        mask[0, 0, 2] = False  # one fully masked query row
        bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    elif case == "kv_lens":
        lens = np.array([9, 0, 4], np.int32)
        kw_j["kv_lens"], kw_t["kv_lens"] = jnp.asarray(lens), torch.from_numpy(lens)
    else:
        kw_j["causal"] = kw_t["causal"] = True
    ref = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j))
    out = dot_product_attention(*_t(q, k, v), **kw_t).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    with pytest.raises(ValueError):
        dot_product_attention(*_t(q, k, v), bias=torch.zeros(1), kv_lens=torch.ones(B))


def _decode_inputs(B, Lk, H, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H * D).astype(np.float32)
    k = rng.randn(B, Lk, H * D).astype(np.float32)
    v = rng.randn(B, Lk, H * D).astype(np.float32)
    return q, k, v, rng


def _jax_decode(q, k, v, mask, H):
    return np.asarray(_decode_attention_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        num_heads=H, interpret=True,
    ))


@pytest.mark.parametrize("B,Lk,H,D,n_valid", [
    pytest.param(3, 100, 4, 64, 100, id="100"),
    pytest.param(3, 128, 4, 64, 128, id="128"),
    pytest.param(3, 1009, 4, 64, 1009, id="1009"),
    # donut_base's cross geometry (H 16, D 64) at B=2: Lk not a multiple of
    # the kernel's 8-key tile at H*D = 1024, the padded tail masked
    pytest.param(2, 4861, 16, 64, 4800, id="donut_cross_lk4861_valid4800"),
])
def test_plain_decode_attention_matches_jax(B, Lk, H, D, n_valid):
    q, k, v, _ = _decode_inputs(B, Lk, H, D, seed=Lk)
    mask = np.zeros((B, Lk), bool)
    mask[:, :n_valid] = True
    out = decode_attention(*_t(q, k, v, mask), num_heads=H).numpy()
    np.testing.assert_allclose(out, _jax_decode(q, k, v, mask, H), **TOL)


def test_plain_decode_attention_ragged_mask_and_dead_row():
    """The self-cache pattern: per-sample prefixes with pad holes; one row
    with no visible key gives zeros."""
    B, Lk, H, D = 5, 160, 2, 32
    q, k, v, rng = _decode_inputs(B, Lk, H, D, seed=7)
    mask = np.zeros((B, Lk), bool)
    for b, n in enumerate([1, 17, 100, 160, 0]):
        mask[b, :n] = True
        if n > 4:
            mask[b, rng.randint(1, n, 3)] = False
    out = decode_attention_plain(*_t(q, k, v, mask), num_heads=H).numpy()
    np.testing.assert_allclose(out, _jax_decode(q, k, v, mask, H), **TOL)
    assert (out[4] == 0).all()

