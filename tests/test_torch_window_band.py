"""The port's banded window-attention probe (kernel #17's plain version, the
wrapper's CPU dispatch and both variants) against the JAX tool's, on the CPU.

The JAX tool (``tools/window_band_probe.py``) is loaded from its path; its
probes run only under ``__main__``. Importing it points JAX's compilation
cache at a directory of its own and puts a fixed path on ``sys.path``: both
are restored right after the import, so no other test in the worker is
touched. The JAX modules it imports are imported from this checkout first,
so its imports find them cached and never load another copy.
Its Pallas kernel runs in interpret mode (``pl.pallas_call`` patched with
``interpret=True``), as the JAX package's tests run kernels on the CPU.

Geometries: the tool's smoke map (1x20x20, C 128, 4 heads, tbw 2) and a
2x20x30 map (C 64, 2 heads, tbw 3). Same numpy inputs on both sides.
Tolerance: fp32 1e-5 (summation order only); bf16 2e-2 (qkv, p and the
output round to 8 mantissa bits, at different places in XLA and PyTorch).

The CUDA kernel's host-side pieces, in pure Python: its one TMA box per
tile (``band_box``, rows in box order) against ``_window_partition``, and
its plan (``band_plan``: ``window_plan`` with period 1) against every
(window, head) pair.
"""

import functools
import importlib.util
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pixparse_tpu.models.swin  # noqa: F401  (cached before the JAX tool imports it)
import pixparse_tpu.ops.window_attention  # noqa: F401
from pixparse_tpu_torch.models.swin import _window_partition
from pixparse_tpu_torch.tools import window_band_probe as port

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# B, Hp, Wp, C, heads, win, tbw
GEOMETRIES = [(1, 20, 20, 128, 4, 10, 2), (2, 20, 30, 64, 2, 10, 3)]


@pytest.fixture(scope="module")
def jax_tool():
    cache_dir = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_jax_window_band_probe", ROOT / "tools" / "window_band_probe.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    for fn in (module.window_attention, module._window_partition, module._window_reverse):
        assert Path(inspect.getfile(fn)).resolve().is_relative_to(ROOT), inspect.getfile(fn)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, Hp, Wp, C, heads, win, seed):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, Hp, Wp, C).astype(np.float32)
    wqkv = (rng.randn(C, 3 * C) * 0.1).astype(np.float32)
    qkv = rng.randn(B, Hp, Wp, 3 * C).astype(np.float32)
    bias = (rng.randn(heads, win * win, win * win) * 0.5).astype(np.float32)
    return h, wqkv, qkv, bias


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hp,Wp,C,heads,win,tbw", GEOMETRIES)
def test_banded_attention_matches_jax(jax_tool, interpret, dtype, B, Hp, Wp, C, heads, win, tbw):
    _, _, qkv, bias = _inputs(B, Hp, Wp, C, heads, win, seed=Wp + C)
    ref = jax_tool.banded_attention(jnp.asarray(qkv, jnp.dtype(dtype)), jnp.asarray(bias), win, tbw)
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    plain = port.banded_attention_plain(tq, torch.from_numpy(bias), win, tbw)
    assert plain.shape == (B, Hp, Wp, C) and plain.dtype == tq.dtype
    _close(plain, ref, dtype)
    before = port.banded_attention.launches
    assert torch.equal(port.banded_attention(tq, torch.from_numpy(bias), win, tbw), plain)
    assert port.banded_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hp,Wp,C,heads,win,tbw", GEOMETRIES)
def test_variants_match_jax(jax_tool, interpret, dtype, B, Hp, Wp, C, heads, win, tbw):
    h, wqkv, _, bias = _inputs(B, Hp, Wp, C, heads, win, seed=Hp + C)
    jdt = jnp.dtype(dtype)
    jh, jw, jb = jnp.asarray(h, jdt), jnp.asarray(wqkv, jdt), jnp.asarray(bias)
    ref_band = jax_tool.variant_banded(jh, jw, jb, win, tbw)
    ref_cur = jax_tool.variant_current(jh, jw, jb, win)
    if dtype == "float32":  # the JAX tool's own parity: the fold changes nothing
        np.testing.assert_allclose(np.asarray(ref_band), np.asarray(ref_cur), atol=1e-5, rtol=1e-5)
    tdt = getattr(torch, dtype)
    th, tw, tb = torch.from_numpy(h).to(tdt), torch.from_numpy(wqkv).to(tdt), torch.from_numpy(bias)
    band = port.variant_banded(th, tw, tb, win, tbw)
    cur = port.variant_current(th, tw, tb, win)
    for got in (band, cur):
        assert got.shape == (B, Hp, Wp, C) and got.dtype == tdt
    _close(band, ref_band, dtype)
    _close(cur, ref_cur, dtype)


def test_bad_geometry_raises():
    qkv = torch.zeros(1, 20, 30, 3 * 64)
    bias = torch.zeros(2, 100, 100)
    port.banded_attention(qkv, bias, 10, 3)  # 3 windows per row, tbw 3: accepted
    cases = [
        (torch.zeros(1, 25, 30, 3 * 64), bias, 3, "whole number of 10x10 windows"),
        (torch.zeros(1, 20, 35, 3 * 64), bias, 3, "whole number of 10x10 windows"),
        # the TPU grid (nww // tbw bands) would leave the last window unwritten
        (qkv, bias, 2, "not a multiple of tbw=2"),
        (qkv, bias, 0, "not a multiple of tbw=0"),
        (qkv, torch.zeros(2, 49, 49), 3, "bias must be"),
        (qkv, torch.zeros(3, 100, 100), 3, "not divisible by heads=3"),
        (torch.zeros(20, 30, 3 * 64), bias, 3, "qkv must be"),
    ]
    for q, b, tbw, match in cases:
        for fn in (port.banded_attention, port.banded_attention_plain):
            with pytest.raises(ValueError, match=match):
                fn(q, b, 10, tbw)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("Hp,Wp", [(20, 20), (40, 30)])
def test_band_box_rows_are_the_partitioned_window(B, Hp, Wp):
    """The kernel's box for (window, head, q/k/v) holds, row for row, what
    ``_window_partition`` puts in that window's head slice."""
    C, heads, win = 64, 2, 10
    D, nwh, nww = C // heads, Hp // win, Wp // win
    qkv = torch.from_numpy(np.random.RandomState(Hp + B).randn(B, Hp, Wp, 3 * C))
    windows = _window_partition(qkv, win)  # (B * nwh * nww, win * win, 3C)
    assert windows.shape[0] == B * nwh * nww
    for n in range(windows.shape[0]):
        b, i, j = port.band_window(n, nwh, nww)
        assert 0 <= b < B and 0 <= i < nwh and 0 <= j < nww
        for h in range(heads):
            for part in range(3):
                box = port.band_box(b, i, j, h, part, C, D, win)
                c0, x0, y0, bb = box
                assert x0 + win <= Wp and y0 + win <= Hp and c0 + D <= 3 * C and bb == b
                want = windows[n, :, part * C + h * D:part * C + (h + 1) * D]
                assert torch.equal(port.box_rows(qkv, box, D, win), want), (n, h, part)


def _block_windows(plan, heads):
    """(head, windows) of every block, as ``window_ring.cuh::block_run``
    cuts a head's items (period 1: item = window)."""
    return [(x % heads, range((x // heads) * plan.items // plan.runs,
                              (x // heads + 1) * plan.items // plan.runs))
            for x in range(plan.grid)]


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("which", list(port.GEOMETRIES))
def test_band_plan_takes_every_window_and_head_once(which, blocks_per_sm):
    _, B, Hp, Wp, C, heads, win, _, _ = port.GEOMETRIES[which]
    n_sms = 132
    plan = port.band_plan(B, Hp, Wp, win, heads, C // heads, n_sms, blocks_per_sm)
    n_windows = B * (Hp // win) * (Wp // win)
    assert plan.items == n_windows and plan.grid == heads * plan.runs
    assert plan.grid <= max(n_sms * blocks_per_sm, heads)
    seen = [(n, h) for h, windows in _block_windows(plan, heads) for n in windows]
    assert len(seen) == len(set(seen)) == n_windows * heads
    sizes = [len(w) for _, w in _block_windows(plan, heads)]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
