"""The port's ``window_attention`` against the JAX package's, on the CPU.

The JAX function runs its Pallas kernel in interpret mode (as the JAX
package's own tests run it); the port's wrapper takes its plain version for
CPU tensors. Same numpy inputs: fp32 within 1e-5, bf16 within 2e-2 (p and
the output round to 8 mantissa bits). The CUDA kernel is held against the
plain version on the card (``tests/test_torch_kernels.py``, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.window_attention import window_attention as jax_window_attention
from pixparse_tpu_torch.ops.window_attention import window_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(nB, N, C, H, nW, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(nB, N, C).astype(np.float32) for _ in range(3))
    bias = (rng.randn(H, N, N) * 0.5).astype(np.float32)
    mask = None
    if nW:
        region = rng.randint(0, 3, (nW, N))
        mask = np.where(region[:, :, None] == region[:, None, :], 0.0, -1e9).astype(np.float32)
    return q, k, v, bias, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("nB,N,C,H,nW", [(8, 16, 64, 4, 4), (6, 100, 96, 3, 3)])
def test_window_attention_matches_jax(dtype, masked, nB, N, C, H, nW):
    q, k, v, bias, mask = _inputs(nB, N, C, H, nW if masked else 0, seed=N + C)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = jax_window_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask),
    )
    out = window_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask),
    )
    assert out.dtype == tdt and out.shape == (nB, N, C)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )


def test_bad_shapes_raise_as_in_jax():
    q, k, v, bias, mask = _inputs(6, 16, 64, 4, 4, seed=0)
    for fn, conv in ((jax_window_attention, jnp.asarray), (window_attention, torch.from_numpy)):
        with pytest.raises(ValueError, match="window count 6 not a multiple of mask period 4"):
            fn(conv(q), conv(k), conv(v), conv(bias), conv(mask))
        with pytest.raises(ValueError, match="C=64 not divisible by heads=3"):
            fn(conv(q), conv(k), conv(v), conv(bias[:3]))
