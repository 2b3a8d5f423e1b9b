"""The port's window-attention backward against the JAX package's, on the CPU.

JAX differentiates ``window_attention`` through its custom VJP, whose Pallas
backward kernel runs in interpret mode (as the JAX package's own tests run
it); the port's autograd Function takes its plain backward for CPU tensors.
Same numpy inputs at the shapes of ``tests/test_window_attention.py``'s
gradient test (12 windows of 25 tokens, C 96, 3 heads, mask period 6), loss
``sum(out^2)``: dq, dk, dv, dbias and the relative-position table's gradient
through the gather, fp32 within 5e-5 (that test's bound), bf16 within 2e-2
of each gradient's largest element (p and ds round to 8 mantissa bits
before their products). The CUDA kernel is held against the plain version on
the card (``tests/test_torch_kernels.py``, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.window_attention import window_attention as jax_window_attention
from pixparse_tpu_torch.models.swin import _rel_pos_index
from pixparse_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_plain,
)

NB, WINDOW, C, H, NW = 12, 5, 96, 3, 6
N = WINDOW * WINDOW


def _inputs(masked, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((NB, N, C)).astype(np.float32) for _ in range(3))
    table = (rng.standard_normal(((2 * WINDOW - 1) ** 2, H)) * 0.5).astype(np.float32)
    mask = None
    if masked:
        region = rng.integers(0, 3, (NW, N))
        mask = np.where(region[:, None, :] != region[:, :, None], -1e9, 0.0).astype(np.float32)
    return q, k, v, table, mask


def _jax_grads(q, k, v, table, mask, dtype):
    index = jnp.asarray(_rel_pos_index(WINDOW).reshape(-1))

    def loss(q, k, v, table, extra):  # d loss / d extra = dbias
        bias = jnp.transpose(table[index].reshape(N, N, H), (2, 0, 1)) + extra
        out = jax_window_attention(q, k, v, bias, None if mask is None else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) ** 2)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)] + [
        jnp.asarray(table), jnp.zeros((H, N, N), jnp.float32)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]


def _port_grads(q, k, v, table, mask, dtype):
    index = torch.from_numpy(_rel_pos_index(WINDOW).reshape(-1))
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tab = torch.from_numpy(table).requires_grad_()
    extra = torch.zeros(H, N, N, requires_grad=True)  # d loss / d extra = dbias
    bias = tab.t()[:, index].reshape(H, N, N) + extra
    out = window_attention(*leaves, bias, None if mask is None else torch.from_numpy(mask))
    out.float().square().sum().backward()
    return [t.grad.float().numpy() for t in leaves + [tab, extra]]


@pytest.mark.parametrize("masked", [True, False])
def test_gradients_match_jax_fp32(masked):
    q, k, v, table, mask = _inputs(masked)
    want = _jax_grads(q, k, v, table, mask, jnp.float32)
    got = _port_grads(q, k, v, table, mask, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv", "dtable", "dbias"), got, want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0, err_msg=name)


def test_gradients_match_jax_bf16():
    q, k, v, table, mask = _inputs(True, seed=2)
    want = _jax_grads(q, k, v, table, mask, jnp.bfloat16)
    got = _port_grads(q, k, v, table, mask, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv", "dtable", "dbias"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-2 * np.abs(b).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(masked):
    """In fp32 the plain backward's rounding points are the identity, so it
    is autograd of the plain forward up to summation order (1e-5)."""
    dtype = torch.float32
    q, k, v, table, mask = _inputs(masked, seed=3)
    rng = np.random.default_rng(4)
    do = torch.from_numpy(rng.standard_normal((NB, N, C))).to(dtype)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    bias = torch.from_numpy(table).t()[:, torch.from_numpy(_rel_pos_index(WINDOW).reshape(-1))]
    bias = bias.reshape(H, N, N).to(dtype).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask).to(dtype)
    want = torch.autograd.grad(window_attention_plain(*leaves, bias, m), leaves + [bias], do)
    got = window_attention_bwd_plain(*leaves, do, bias, m)
    assert window_attention_bwd(*leaves, do, bias, m)[3].shape == (H, N, N)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_mask_gets_no_gradient_and_bias_does():
    q, k, v, table, mask = _inputs(True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    bias = torch.zeros(H, N, N, requires_grad=True)
    m = torch.from_numpy(mask).requires_grad_()
    window_attention(*leaves, bias, m).sum().backward()
    assert m.grad is None and bias.grad is not None and bias.grad.abs().sum() > 0
