"""The port's MXU-probe sum (kernel #16's plain version, and the wrapper's
CPU dispatch) against the JAX tool's three kernel bodies, on the CPU.

``tools/mxu_probe.py`` runs its probes at module level, so it is never
imported: the test loads only its imports, constants and the three
``kern_*`` functions from its source with ``ast``, sets M, N and R small in
that namespace (the kernels read them as globals) and runs each body through
``pl.pallas_call(..., grid=(1,), interpret=True)``. Same numpy operands for
both (uniform [0, 1), as the tool's), fp32 and bf16 (both sides sum in fp32).

Tolerance: 1e-5 relative. Each output element is a sum of 512 positive
products (values ~150) that the two sides take in another order; fp32
rounding of such a sum stays within a few units of 6e-8 relative (measured:
~2e-7).

The CUDA kernel's persistent schedule (``probe_schedule``: block -> its
(tile, repeat) pairs) is checked in pure Python: every pair once, in one
balanced wave.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pixparse_tpu_torch.tools import mxu_probe

ROOT = Path(__file__).resolve().parent.parent
M, N, R = 64, 32, 4  # small: the JAX kernels read these as globals
RTOL = 1e-5
JAX_KERNELS = {"k64": "kern_k64", "k128": "kern_k128", "k64x2": "kern_k64x2"}


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool's imports, constants and ``kern_*`` bodies, nothing
    that runs (its probes and the compile-cache setting are left out)."""
    path = ROOT / "tools" / "mxu_probe.py"
    tree = ast.parse(path.read_text(), str(path))
    keep = [
        node for node in tree.body
        if isinstance(node, (ast.Import, ast.ImportFrom))
        or (isinstance(node, ast.Assign) and all(isinstance(t, ast.Name) for t in node.targets))
        or (isinstance(node, ast.FunctionDef) and node.name.startswith("kern_"))
    ]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    assert set(JAX_KERNELS.values()) <= set(ns)
    full = {k: ns[k] for k in ("M", "N", "R", "G")}
    ns.update(M=M, N=N, R=R)
    return ns, full


def _jax_sum(ns, variant, a, b, dtype):
    W = a.shape[2]
    call = pl.pallas_call(
        ns[JAX_KERNELS[variant]],
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((32, M, W), lambda i: (0, 0, 0)),
                  pl.BlockSpec((32, W, N), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda i: (0, 0)),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(a, dtype), jnp.asarray(b, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(JAX_KERNELS))
def test_plain_sum_matches_jax_kernel(jax_tool, variant, dtype):
    ns, _ = jax_tool
    W, _ = mxu_probe.VARIANTS[variant]
    rng = np.random.RandomState(len(variant) + len(dtype))
    a = rng.rand(32, M, W).astype(np.float32)
    b = rng.rand(32, W, N).astype(np.float32)
    ref = _jax_sum(ns, variant, a, b, jnp.dtype(dtype))
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    plain = mxu_probe.mxu_dots_plain(ta, tb, variant, dots=R)
    assert plain.dtype == torch.float32 and plain.shape == (M, N)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=RTOL, atol=0)
    # the wrapper on CPU tensors: the plain sum in every repeat's slab, no launch
    before = mxu_probe.mxu_dots.launches
    out = mxu_probe.mxu_dots(ta, tb, variant, dots=R, repeats=3)
    assert out.shape == (3, M, N) and mxu_probe.mxu_dots.launches == before
    assert all(torch.equal(out[g], plain) for g in range(3))


def test_dot_counts_and_normalisation_are_the_tools(jax_tool):
    """Equal useful work in the three variants, and useful FLOP counted as
    the JAX tool counts it (2 x G x R x M x N x 128 at its full size)."""
    _, full = jax_tool
    assert {v: mxu_probe.n_dots(v, R) for v in JAX_KERNELS} == {"k64": 2 * R, "k128": R,
                                                                 "k64x2": 2 * R}
    assert (mxu_probe.M, mxu_probe.N, mxu_probe.R, mxu_probe.G) == tuple(
        full[k] for k in ("M", "N", "R", "G"))
    macs = full["G"] * full["R"] * full["M"] * full["N"] * 128
    assert mxu_probe.useful_flop() == 2 * macs


def test_library_operands_give_the_same_sum():
    """The yardstick's one batched product computes the function."""
    for variant in JAX_KERNELS:
        a, b = mxu_probe.operands(variant, "cpu", m=M, n=N)
        a_rep, b_rep = mxu_probe.library_operands(a.float(), b.float(), variant, dots=R, repeats=2)
        got = torch.matmul(a_rep, b_rep)
        want = mxu_probe.mxu_dots_plain(a.float(), b.float(), variant, dots=R)
        torch.testing.assert_close(got[1], want, rtol=RTOL, atol=0)


def test_wrapper_rejects_bad_operands():
    a, b = mxu_probe.operands("k64", "cpu", m=M, n=N)
    with pytest.raises(ValueError, match="variant"):
        mxu_probe.mxu_dots(a, b, "k32")
    with pytest.raises(ValueError, match="a \\(S, M, 128\\)"):
        mxu_probe.mxu_dots(a, b, "k128")  # 64-wide buffers
    with pytest.raises(ValueError, match="same S slabs"):
        mxu_probe.mxu_dots(a[:16], b, "k64")
    with pytest.raises(ValueError, match="must be positive"):
        mxu_probe.mxu_dots(a, b, "k64", dots=0)
    with pytest.raises(ValueError, match="must be positive"):
        mxu_probe.mxu_dots(a, b, "k64", repeats=0)


@pytest.mark.parametrize("m,n,repeats", [
    (mxu_probe.M, mxu_probe.N, mxu_probe.G),  # the tool's size: 1024 pairs
    (128, 128, 1),
    (128, 128, 3),
    (256, 384, 2),  # N not a multiple of 256: 128-column tiles
])
def test_probe_schedule_takes_every_pair_once(m, n, repeats):
    n_sms = 132
    schedule = mxu_probe.probe_schedule(m, n, repeats, n_sms)
    bn = mxu_probe.tile_cols(n)
    assert bn == (256 if n % 256 == 0 else 128)
    want = {(g, m0, n0) for g in range(repeats) for m0 in range(0, m, 128)
            for n0 in range(0, n, bn)}
    got = [pair for block in schedule for pair in block]
    assert len(got) == len(set(got)) == len(want) and set(got) == want
    assert len(schedule) == min(len(want), n_sms)  # one wave, one block per SM
    sizes = [len(block) for block in schedule]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
