"""The LayerNorm forward kernel's work split, on the CPU.

- ``layer_norm_config`` / ``layer_norm_plan`` / ``layer_norm_fwd_groups``
  (pure Python, mirrors of the forward kernel's launch): the rows of every
  shape are cut into groups that the blocks take exactly once (block i
  groups i, i + n_blocks, ...), the grid is one resident wave (at most SMs
  x the kernel's blocks per SM), no block takes more groups than it must,
  and at D = 128 a row's 16 lanes each hold one chunk of 8 (no lane idle).
- ``layer_norm_fwd_plain``, the version the kernel is held against on the
  card, against the JAX package's LayerNorm forward (its Pallas kernel in
  interpret mode, and ``_ln_ref``) at every (threads a row, chunks a
  thread) shape the kernel takes: within 1e-5 in fp32, one bf16 step
  (1e-2 + 1e-2 |ref|) in bf16.

The CUDA kernel is held against the plain version on the card
(``tests/test_torch_kernels.py``, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops.layer_norm import _ln_ref
from pixparse_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from pixparse_tpu_torch.ops.layer_norm import (
    LN_THREADS,
    layer_norm_config,
    layer_norm_fwd_plain,
    layer_norm_plan,
    layer_norm_fwd_groups,
)

SMS = 132  # an H100's SMs
DONUT_STEP = ((614400, 128), (153600, 256), (153600, 512), (38400, 512), (38400, 1024),
              (9600, 1024), (9600, 2048), (3070, 1024))


@pytest.mark.parametrize("R,D", DONUT_STEP + ((1, 8), (3, 8192), (3070, 136), (77, 1024), (5, 128)))
@pytest.mark.parametrize("elt,blocks_per_sm", [(2, 2), (4, 2), (2, 1)])
def test_fwd_plan_takes_every_row_once_in_one_wave(R, D, elt, blocks_per_sm):
    G, n_groups, n_blocks = layer_norm_plan(R, D, elt, SMS, blocks_per_sm)
    tr, k, u = layer_norm_config(D, elt)
    assert G == (LN_THREADS // tr) * u
    assert (n_groups - 1) * G < R <= n_groups * G
    assert 1 <= n_blocks <= min(n_groups, SMS * blocks_per_sm)  # one resident wave
    rows = np.zeros(R, np.int64)
    taken = []
    for i in range(n_blocks):
        groups = layer_norm_fwd_groups(n_groups, n_blocks, i)
        assert len(groups) >= 1  # every block some
        taken.append(len(groups))
        for g in groups:
            rows[g * G:(g + 1) * G] += 1
    assert (rows == 1).all()  # every row exactly once
    assert max(taken) == -(-n_groups // (SMS * blocks_per_sm))  # no block takes more than it must


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("D", [8, 64, 128, 136, 512, 1024, 2048, 4096, 8192])
def test_fwd_lanes_cover_the_row(D, elt):
    tr, k, u = layer_norm_config(D, elt)
    assert tr * k * 8 >= D > (tr // 2) * k * 8 or k == 4 or tr == 1
    if D == 128:  # Swin stage 0: 16 lanes a row, each one chunk, no lane idle
        assert (tr, k) == (16, 1) and tr * k * 8 == D


def _inputs(R, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, D)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("D", [8, 128, 136, 512, 1024, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax(D, dtype):
    x, w, b = _inputs(37, D, D)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layer_norm_fwd_plain(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    assert got.dtype == xt.dtype
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    for fn in (lambda: jax_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), 1e-6, impl="pallas"),
               lambda: _ln_ref(xj, jnp.asarray(w), jnp.asarray(b), 1e-6)):
        want = np.asarray(fn().astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
