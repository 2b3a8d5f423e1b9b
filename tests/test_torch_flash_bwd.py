"""Gradients of the port's ``flash_attention`` against ``jax.grad`` of the
JAX package's ``flash_attention`` on the same numpy inputs, fp32, on the CPU.

The JAX side runs its Pallas backward kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port takes the plain version of
its backward kernels (a CPU tensor), which has the kernels' rounding points.
Tolerance: atol = rtol = 5e-4, the bound ``tests/test_flash_attention.py``
holds the JAX kernels to against XLA attention (fp32 sums in another order).
The CUDA kernels are held against the same plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.flash_attention import flash_attention as jax_flash
from pixparse_tpu_torch.ops.attention import dot_product_attention
from pixparse_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
)

TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(B, Lq, Lk, H, D, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, Lq, H, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, Lk, H, D) * 0.5).astype(np.float32)
    v = rng.randn(B, Lk, H, D).astype(np.float32)
    do = rng.randn(B, Lq, H, D).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, kv_lens):
    lens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)

    def f(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=128, block_k=128, kv_lens=lens)
        return jnp.sum(out * jnp.asarray(do)), out

    grads, out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return [np.asarray(g) for g in grads], np.asarray(out)


def _torch_grads(q, k, v, do, causal, kv_lens, fn=flash_attention):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    lens = None if kv_lens is None else torch.tensor(kv_lens, dtype=torch.int32)
    out = fn(*leaves, causal=causal, kv_lens=lens)
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in leaves], out.detach().numpy()


@pytest.mark.parametrize(
    "B,Lq,Lk,H,D,causal,kv_lens",
    [
        (2, 160, 160, 2, 64, False, None),
        (2, 160, 160, 2, 64, True, None),
        (1, 100, 75, 3, 32, False, None),  # Lq != Lk, both unaligned
        (1, 32, 96, 2, 64, True, None),  # bottom-right causal, Lq < Lk
        (4, 37, 53, 4, 64, False, [53, 0, 17, 40]),  # kv_lens with an empty row
        (3, 45, 45, 2, 32, True, [45, 20, 1]),  # causal with kv_lens (Lq == Lk)
    ],
)
def test_flash_gradients_match_jax(B, Lq, Lk, H, D, causal, kv_lens):
    q, k, v, do = _inputs(B, Lq, Lk, H, D, seed=Lq + Lk)
    want, out_ref = _jax_grads(q, k, v, do, causal, kv_lens)
    got, out = _torch_grads(q, k, v, do, causal, kv_lens)
    np.testing.assert_allclose(out, out_ref, atol=2e-5, rtol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if kv_lens is not None and 0 in kv_lens:
        row = kv_lens.index(0)
        # no valid key: p = 0 everywhere, every gradient of the row vanishes
        assert all(np.all(g[row] == 0) for g in got)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_through_plain_attention(causal):
    """The hand-written plain backward against autograd through the plain
    attention (a gradcheck of the formulas), with key lengths that keep
    every row alive (the two paths differ, by design, on rows without a
    key)."""
    q, k, v, do = _inputs(2, 29, 29, 3, 32, seed=7)
    lens = [29, 11]
    got, _ = _torch_grads(q, k, v, do, causal, lens)
    want, _ = _torch_grads(
        q, k, v, do, causal, lens,
        fn=lambda q, k, v, causal, kv_lens: dot_product_attention(
            q, k, v, causal=causal, kv_lens=kv_lens),
    )
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)


def test_backward_wrapper_routes_cpu_tensors_to_plain_and_rounds_like_the_kernel():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 20, 33, 2, 32, seed=3))
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, do, lse, delta)
    want = flash_attention_bwd_plain(q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == before  # counts kernel launches only
    # bf16: p and ds round to bf16 before their products, outputs are bf16
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob, lseb = flash_attention_fwd(qb, kb, vb)
    deltab = (dob.float() * ob.float()).sum(-1).permute(0, 2, 1).contiguous()
    gb = flash_attention_bwd(qb, kb, vb, dob, lseb, deltab)
    assert all(g.dtype == torch.bfloat16 for g in gb)
    for a, b in zip(gb, want):
        torch.testing.assert_close(a.float(), b, atol=6e-2, rtol=6e-2)


def test_causal_with_kv_lens_needs_equal_lengths():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 8, 12, 1, 32, seed=0))
    with pytest.raises(ValueError, match="Lq == Lk"):
        flash_attention(q, k, v, causal=True, kv_lens=torch.tensor([5]))
