"""The port's LayerNorm against the JAX package's, on the CPU in fp32.

Both of the port's paths (``impl='xla'``, plain autograd; ``impl='pallas'``,
the autograd Function over the kernels, which takes their plain versions for
CPU tensors) are held against the JAX ``layer_norm(..., impl='pallas')``
(its Pallas kernels in interpret mode, as the JAX package's tests run them)
and against its ``_ln_ref``: output and the gradients of x, scale and bias
within 1e-5 (fp32, other summation order). ``PIXPARSE_LN_IMPL`` selects the
implementation as in JAX. The CUDA kernels are held against the plain
versions on the card (``tests/test_torch_kernels.py``, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.layer_norm import _ln_ref
from pixparse_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from pixparse_tpu_torch.ops.layer_norm import (
    LayerNorm,
    layer_norm,
    layer_norm_bwd_plain,
    layer_norm_fwd_plain,
    resolve_ln_impl,
)

EPS = 1e-6


def _inputs(R, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, D)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32)
    dy = rng.standard_normal((R, D)).astype(np.float32)
    return x, w, b, dy


def _jax(fn, x, w, b, dy):
    y, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, w, b)))
    return [np.asarray(t) for t in (y, *vjp(jnp.asarray(dy)))]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("R,D", [(37, 256), (64, 1024)])
def test_layer_norm_matches_jax(impl, R, D):
    x, w, b, dy = _inputs(R, D, R + D)
    kernel = _jax(lambda x, w, b: jax_layer_norm(x, w, b, EPS, impl="pallas"), x, w, b, dy)
    ref = _jax(lambda x, w, b: _ln_ref(x, w, b, EPS), x, w, b, dy)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, w, b)]
    y = layer_norm(*leaves, EPS, impl=impl)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = [y.detach().numpy()] + [g.numpy() for g in grads]
    for want in (kernel, ref):
        for name, a, c in zip(("y", "dx", "dscale", "dbias"), got, want):
            np.testing.assert_allclose(a, c, atol=1e-5, rtol=1e-5, err_msg=f"{impl} {name}")


def test_plain_kernel_versions_match_autograd():
    x, w, b, dy = (torch.from_numpy(t) for t in _inputs(50, 136, 0))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(layer_norm_fwd_plain(*leaves, EPS), leaves, dy)
    got = layer_norm_bwd_plain(x, w, dy, EPS)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5, msg=name)


def test_bf16_output_in_input_dtype():
    x, w, b, dy = _inputs(8, 64, 1)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    y = layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b), EPS, impl="pallas")
    y.backward(torch.from_numpy(dy).bfloat16())
    assert y.dtype == torch.bfloat16 and xb.grad.dtype == torch.bfloat16
    ref = _ln_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), EPS)
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_env_selects_the_implementation_as_in_jax(monkeypatch):
    monkeypatch.delenv("PIXPARSE_LN_IMPL", raising=False)
    assert resolve_ln_impl() == "xla" and resolve_ln_impl("pallas") == "pallas"
    x = torch.randn(4, 32, requires_grad=True)
    norm = LayerNorm(32)
    assert not any("_LayerNorm" in type(f).__name__ for f in _graph(norm(x).grad_fn))
    monkeypatch.setenv("PIXPARSE_LN_IMPL", "pallas")
    assert resolve_ln_impl() == "pallas" and resolve_ln_impl("xla") == "xla"
    # the module routes through the Function (its plain versions on the CPU)
    assert any("_LayerNorm" in type(f).__name__ for f in _graph(norm(x).grad_fn))
    monkeypatch.setenv("PIXPARSE_LN_IMPL", "triton")
    with pytest.raises(ValueError, match="LayerNorm impl"):
        norm(x)
    with pytest.raises(ValueError, match="LayerNorm impl"):
        layer_norm(x, norm.weight, norm.bias, impl="cuda")


def _graph(fn, seen=None):
    seen = [] if seen is None else seen
    if fn is not None and fn not in seen:
        seen.append(fn)
        for nxt, _ in fn.next_functions:
            _graph(nxt, seen)
    return seen
