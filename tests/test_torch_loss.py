"""The port's loss functions against the JAX package's on the same numpy
inputs, fp32, on the CPU.

The JAX fused CE runs its Pallas kernels in interpret mode, as
``tests/test_fused_ce.py`` does; the port takes the plain versions of its
CUDA kernels (CPU tensors). Tolerances: loss 1e-5, dh/dE atol 1e-5, the
bounds ``tests/test_fused_ce.py`` holds the JAX kernels to (fp32 sums in
another order). The CUDA kernels are held against the same plain versions on
the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops import loss as jl
from pixparse_tpu_torch.ops import loss as tl


def _data(B, L, D, V, seed=0, ignore=True):
    rng = np.random.RandomState(seed)
    hidden = (rng.randn(B, L, D) * 0.5).astype(np.float32)
    emb = (rng.randn(V, D) * 0.2).astype(np.float32)
    tgt = rng.randint(0, V, (B, L)).astype(np.int64)
    if ignore:
        tgt[0, :5] = -100
        tgt[-1, -3:] = -100
    return hidden, emb, tgt


def _jax_loss_and_grads(fn, hidden, emb, tgt):
    f = lambda h, e: fn(h, e, jnp.asarray(tgt, jnp.int32))
    (loss, n), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(emb)
    )
    return float(loss), int(n), [np.asarray(g) for g in grads]


def _torch_loss_and_grads(fn, hidden, emb, tgt):
    h = torch.from_numpy(hidden).requires_grad_()
    e = torch.from_numpy(emb).requires_grad_()
    loss, n = fn(h, e, torch.from_numpy(tgt))
    loss.backward()
    return float(loss.detach()), int(n), [h.grad.numpy(), e.grad.numpy()]


def test_cross_entropy_loss_matches_jax():
    hidden, emb, tgt = _data(4, 19, 16, 101)
    logits = hidden @ emb.T
    want, n_want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt, jnp.int32))
    got, n_got = tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(tgt))
    assert abs(float(got) - float(want)) < 1e-5 and int(n_got) == int(n_want)


# ragged V (not a multiple of any tile) and T; an aligned case
@pytest.mark.parametrize("B,L,D,V", [(8, 37, 48, 307), (2, 128, 64, 512), (3, 5, 16, 33)])
@pytest.mark.parametrize("impl", ["fused", "chunked", "dispatch"])
def test_ce_from_hidden_matches_jax(impl, B, L, D, V):
    hidden, emb, tgt = _data(B, L, D, V, seed=V)
    jax_fn = {"fused": jl.fused_cross_entropy_from_hidden,
              "chunked": jl.chunked_cross_entropy_from_hidden,
              "dispatch": jl.cross_entropy_from_hidden}[impl]
    torch_fn = {"fused": tl.fused_cross_entropy_from_hidden,
                "chunked": tl.chunked_cross_entropy_from_hidden,
                "dispatch": tl.cross_entropy_from_hidden}[impl]
    want, n_want, g_want = _jax_loss_and_grads(jax_fn, hidden, emb, tgt)
    got, n_got, g_got = _torch_loss_and_grads(torch_fn, hidden, emb, tgt)
    assert abs(got - want) < 1e-5
    assert n_got == n_want == int((tgt != -100).sum())
    for name, a, b in zip(("dh", "dE"), g_got, g_want):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_fused_ce_at_donut_width_matches_jax():
    """donut's decoder width, 1024 (T 32, V 300): the CUDA kernels take it
    in bf16 too."""
    assert 1024 in tl.CE_BF16_WIDTHS
    hidden, emb, tgt = _data(2, 16, 1024, 300, seed=1024)
    want, n_want, g_want = _jax_loss_and_grads(jl.fused_cross_entropy_from_hidden, hidden, emb, tgt)
    got, n_got, g_got = _torch_loss_and_grads(tl.fused_cross_entropy_from_hidden, hidden, emb, tgt)
    assert abs(got - want) < 1e-5 and n_got == n_want
    for name, a, b in zip(("dh", "dE"), g_got, g_want):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fn", [tl.fused_cross_entropy_from_hidden,
                                tl.chunked_cross_entropy_from_hidden])
def test_all_ignored_batch_gives_zero_loss_and_zero_grads(fn):
    hidden, emb, tgt = _data(2, 4, 16, 33, ignore=False)
    tgt[:] = -100
    loss, n, (dh, de) = _torch_loss_and_grads(fn, hidden, emb, tgt)
    assert loss == 0.0 and n == 0
    assert np.all(dh == 0) and np.all(de == 0)
    want, n_want, _ = _jax_loss_and_grads(jl.fused_cross_entropy_from_hidden, hidden, emb, tgt)
    assert want == 0.0 and n_want == 0


def test_plain_versions_have_the_kernels_semantics():
    """Ignored rows (target -1) match no column; the plain backward rounds g
    to the hidden dtype before its two products."""
    hidden, emb, tgt = _data(2, 9, 16, 41)
    h = torch.from_numpy(hidden.reshape(-1, 16))
    e = torch.from_numpy(emb)
    t = torch.from_numpy(tgt.reshape(-1))
    safe = torch.where(t == -100, -1, t)
    lse, tgt_logit = tl.fused_ce_fwd_plain(h, e, safe)
    assert torch.all(tgt_logit[safe < 0] == 0)
    torch.testing.assert_close(lse, torch.logsumexp(h @ e.t(), -1))
    before = tl.fused_ce_fwd.launches, tl.fused_ce_bwd.launches
    assert all(torch.equal(a, b) for a, b in zip(tl.fused_ce_fwd(h, e, safe), (lse, tgt_logit)))
    coef = torch.where(safe >= 0, 1.0 / 13, 0.0)
    dh, de = tl.fused_ce_bwd(h, e, safe, lse, coef)
    assert (tl.fused_ce_fwd.launches, tl.fused_ce_bwd.launches) == before  # kernels only
    assert torch.all(dh[safe < 0] == 0)
    dhb, deb = tl.fused_ce_bwd_plain(h.bfloat16(), e.bfloat16(), safe, lse, coef)
    assert dhb.dtype == deb.dtype == torch.bfloat16
    torch.testing.assert_close(dhb.float(), dh, atol=2e-3, rtol=5e-2)


def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (0 at 0)."""
    _, ex = torch.frexp(x.abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), ex - 8))


# V = 384: a chunk of the whole vocabulary, 128 (three even chunks) and 100
# (a ragged last chunk of 84)
@pytest.mark.parametrize("vocab_chunk", [384, 128, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_plain_backward_matches_unchunked_and_jax(dtype, vocab_chunk):
    """The plain backward in the bf16 kernels' order (g per vocabulary
    chunk, dE per chunk, dh summed in fp32 chunk by chunk) against the
    unchunked plain version (fp32: 1e-6; bf16: one bf16 step of the rounded
    outputs, which round the same fp32 sums taken in another order) and, in
    fp32, against the JAX package's fused-CE gradients (Pallas kernels in
    interpret mode) at the file's atol 1e-5."""
    hidden, emb, tgt = _data(2, 37, 48, 384, seed=vocab_chunk)
    t = torch.from_numpy(tgt.reshape(-1))
    valid = t != -100
    safe = torch.where(valid, t, -1)
    h = torch.from_numpy(hidden.reshape(-1, 48)).to(dtype)
    e = torch.from_numpy(emb).to(dtype)
    lse, _ = tl.fused_ce_fwd_plain(h, e, safe)
    coef = torch.where(valid, 1.0 / int(valid.sum()), 0.0)
    dh, de = tl.fused_ce_bwd_plain(h, e, safe, lse, coef, vocab_chunk=vocab_chunk)
    dh_ref, de_ref = tl.fused_ce_bwd_plain(h, e, safe, lse, coef)
    assert dh.dtype == de.dtype == dtype
    assert torch.all(dh[~valid] == 0)
    for name, a, b in (("dh", dh, dh_ref), ("dE", de, de_ref)):
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)
        else:
            assert torch.all((a - b).abs() <= _bf16_step(torch.maximum(a.abs(), b.abs()))), name
    if dtype == torch.float32:
        _, _, (g_dh, g_de) = _jax_loss_and_grads(jl.fused_cross_entropy_from_hidden, hidden, emb, tgt)
        np.testing.assert_allclose(dh.numpy(), g_dh.reshape(-1, 48), atol=1e-5, err_msg="dh")
        np.testing.assert_allclose(de.numpy(), g_de, atol=1e-5, err_msg="dE")


@pytest.mark.parametrize("T,V,D,n_chunks", [
    (16368, 50265, 768, 7),  # cruller_base's train step
    (3070, 57525, 1024, 2),  # donut_base's
    (16368, 8193, 64, 2),  # one full chunk and one row
    (16368, 100, 768, 1),  # V below one vocabulary tile
    (1, 50265, 768, 1),  # one token
    (1, 1, 64, 1),
])
def test_ce_bwd_plan_covers_the_vocabulary_within_budget(T, V, D, n_chunks):
    Vc, chunks, ws_bytes = tl._ce_bwd_plan(T, V, D)
    tile = tl.CE_BWD_VOCAB_TILE
    assert len(chunks) == n_chunks
    assert Vc % tile == 0 and Vc > 0
    assert chunks[0][0] == 0 and chunks[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))  # in order, no gaps
    assert all(v0 % tile == 0 and 0 < v1 - v0 <= Vc for v0, v1 in chunks)
    assert ws_bytes == 2 * T * Vc <= tl.CE_BWD_WORKSPACE_BYTES


@pytest.mark.parametrize("T,V,n_vtiles", [
    (16368, 50265, 197),  # cruller_base's train step: 25.8 MB of partials
    (3070, 57525, 225),  # donut_base's: 5.5 MB
    (300, 517, 3),  # V not a multiple of the 256-entry tile
    (65, 256, 1),  # exactly one tile
    (65, 257, 2),  # one tile and one entry
    (1, 1, 1),
])
def test_ce_fwd_plan_partials_cover_the_vocabulary(T, V, n_vtiles):
    """The bf16 forward keeps one fp32 (max, sum-exp) pair per token and
    vocabulary tile: every column of the vocabulary falls in exactly one
    tile, the last one maybe partial."""
    n, nbytes = tl._ce_fwd_plan(T, V)
    tile = tl.CE_BWD_VOCAB_TILE
    assert n == n_vtiles
    assert (n - 1) * tile < V <= n * tile
    assert nbytes == 2 * 4 * n * T

