"""The LayerNorm backward kernel's work split, on the CPU.

- ``layer_norm_config`` / ``layer_norm_plan`` /
  ``layer_norm_bwd_row_ranges`` (pure Python, mirrors of the kernel's
  launch): a row's threads and chunks cover its width, 16 lanes a row at
  D = 128, a row group of at most 16 KB per operand, one wave of blocks,
  and the blocks' row ranges cover the R rows exactly once, in order.
- ``layer_norm_bwd_plain(..., row_ranges=...)``, dweight/dbias summed as
  the kernels sum them, against the JAX package's LayerNorm (its Pallas
  kernels in interpret mode, and ``_ln_ref``) within the tolerances of
  ``tests/test_torch_layer_norm.py`` (1e-5, fp32).

The CUDA kernels are held against this plain version on the card
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
    layer_norm_config,
    layer_norm_bwd_plain,
    layer_norm_plan,
    layer_norm_bwd_row_ranges,
)

SMS = 132  # an H100's SMs
WIDTHS = (8, 16, 24, 64, 128, 136, 256, 512, 1000, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("D", WIDTHS)
def test_layer_norm_bwd_config(D, elt):
    tr, k, u = layer_norm_config(D, elt)
    assert tr & (tr - 1) == 0 and 1 <= tr <= 256
    assert D <= tr * k * 8  # the row's threads cover its chunks of 8
    assert tr == 1 or k == 4 or (tr // 2) * k * 8 < D  # with no narrower row
    assert u * k <= (4 if elt == 2 else 2) or u == 1
    G = (256 // tr) * u
    assert G * D * elt <= 16384 * (2 if D > 4096 and elt == 4 else 1)
    if D == 128:
        assert (tr, k, u) == (16, 1, 4 if elt == 2 else 2)  # 16 lanes a row, no lane idle


@pytest.mark.parametrize("R,D", [
    (614400, 128), (153600, 256), (153600, 512), (38400, 512), (38400, 1024), (9600, 1024),
    (9600, 2048), (3070, 1024),  # the donut_base B=2 step's shapes
    (1, 8), (3, 8192), (1000, 136), (77, 1024), (5, 128),
])
@pytest.mark.parametrize("elt,blocks_per_sm", [(2, 2), (4, 1)])
def test_layer_norm_bwd_row_ranges_cover_rows_once(R, D, elt, blocks_per_sm):
    G, n_groups, n_blocks = layer_norm_plan(R, D, elt, SMS, blocks_per_sm)
    assert (n_groups - 1) * G < R <= n_groups * G
    assert 1 <= n_blocks <= min(n_groups, SMS * blocks_per_sm)
    ranges = layer_norm_bwd_row_ranges(R, G, n_groups, n_blocks)
    assert len(ranges) == n_blocks and ranges[0][0] == 0 and ranges[-1][1] == R
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(R, R)]):
        assert lo < hi == nxt and lo % G == 0  # whole groups, each block some
    groups = [-(-(hi - lo) // G) for lo, hi in ranges]
    assert max(groups) - min(groups) <= 1  # balanced to a group
    assert max(groups) == -(-n_groups // (SMS * blocks_per_sm))  # no block takes more than it must


def _inputs(R, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, D)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32)
    dy = rng.standard_normal((R, D)).astype(np.float32)
    return x, w, b, dy


@pytest.mark.parametrize("R,D,sms", [(300, 128, 2), (37, 256, 1), (64, 1024, 4), (1000, 136, 3)])
def test_plain_in_kernel_order_matches_jax(R, D, sms):
    x, w, b, dy = _inputs(R, D, R + D)
    plan = layer_norm_plan(R, D, 4, sms, 2)
    ranges = layer_norm_bwd_row_ranges(R, *plan)
    assert len(ranges) > 1
    got = layer_norm_bwd_plain(*(torch.from_numpy(t) for t in (x, w, dy)), 1e-6,
                               row_ranges=ranges)
    for fn in (lambda x, w, b: jax_layer_norm(x, w, b, 1e-6, impl="pallas"),
               lambda x, w, b: _ln_ref(x, w, b, 1e-6)):
        _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, w, b)))
        want = [np.asarray(t) for t in vjp(jnp.asarray(dy))]
        for name, a, c in zip(("dx", "dscale", "dbias"), got, want):
            np.testing.assert_allclose(a.numpy(), c, atol=1e-5, rtol=1e-5, err_msg=name)
