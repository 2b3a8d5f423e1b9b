"""Banded window-attention probe: the port's counterpart of the JAX
package's ``tools/window_band_probe.py`` (kernel #17, ``csrc/window_band.cu``).

The Swin block's attention today (``models/swin.py``) copies the NHWC map
into windows (``_window_partition``), projects them to q/k/v, runs the window
kernel (#14, ``ops/window_attention.py``) and copies the windows back
(``_window_reverse``). Question: does a kernel that reads each window
straight from the NHWC qkv map, and writes o straight back to it, beat that
path? On the TPU the fold meant an unaligned (win, win, C) -> (ww, C)
relayout in VMEM; on the card each window row is ``win`` contiguous pixels,
so the gather is address arithmetic.

- :func:`variant_current`: partition -> ``@ wqkv`` -> kernel #14 -> reverse;
- :func:`variant_banded`: ``h @ wqkv`` on the NHWC map -> kernel #17
  (:func:`banded_attention`), no copy of the map.

Both include the same projection, so their difference is the two copies
against the in-kernel gather. :func:`run` also times the two kernels alone
on the same windows.

Since the kernel is #14's design (persistent runs, a TMA ring, bias[h] in
shared memory: ``csrc/window_ring.cuh``) with one 4-D tensor map over the
NHWC map as its gather, the answer is a banded path whose kernel runs at
#14's rate: what the two copies cost against an in-kernel gather.

Geometries (window 10, the JAX tool's): the stage grids of a 1280x960 page,
half of donut_base's 2560x1920 in each dimension, at B = 4: ``stage0`` 320x240
(C 128, 4 heads), ``stage2`` 80x60 (C 512, 16 heads); ``reshape`` is a 20x20
smoke map (C 128, 4 heads). ``tbw`` is the TPU kernel's band of windows per
tile; the port takes it only to check the same geometry: ``(Wp // win) %
tbw`` must be 0 (the TPU grid, ``nww // tbw`` bands, never writes the last
windows otherwise).
The CUDA kernel takes bf16, head dims 16, 32 and 64 and windows of at most
144 tokens (the window ring's shapes); other shapes raise on a CUDA tensor
(the plain version takes any).

Run on the card (importing this module runs nothing)::

    python -m pixparse_tpu_torch.tools.window_band_probe [reshape|stage0|stage2|all]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.models.swin import _window_partition, _window_reverse
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops.window_attention import (
    HEAD_DIMS,
    MAX_WINDOW_TOKENS,
    WindowPlan,
    _n_sms,
    _tables,
    table_layout,
    window_attention,
    window_attention_plain,
    window_plan,
)
from pixparse_tpu_torch.tools import event_ms

# which -> (label, B, Hp, Wp, C, heads, win, tbw, timed iterations)
GEOMETRIES = {
    "reshape": ("reshape-smoke", 1, 20, 20, 128, 4, 10, 2, 5),
    "stage0": ("stage0 320x240 C128", 4, 320, 240, 128, 4, 10, 6, 30),
    "stage2": ("stage2  80x60 C512", 4, 80, 60, 512, 16, 10, 6, 30),
}


def _check_geometry(qkv, bias, win, tbw):
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(
            f"banded_attention: qkv must be (B, Hp, Wp, 3C) (got {tuple(qkv.shape)})"
        )
    B, Hp, Wp, C3 = qkv.shape
    heads, ww = bias.shape[0], win * win
    if bias.shape != (heads, ww, ww):
        raise ValueError(
            f"banded_attention: bias must be (heads, {ww}, {ww}) (got {tuple(bias.shape)})"
        )
    if (C3 // 3) % heads:
        raise ValueError(f"banded_attention: C={C3 // 3} not divisible by heads={heads}")
    if Hp % win or Wp % win:
        raise ValueError(
            f"banded_attention: map {Hp}x{Wp} is not a whole number of {win}x{win} windows"
        )
    if tbw <= 0 or (Wp // win) % tbw:
        raise ValueError(
            f"banded_attention: {Wp // win} windows per row is not a multiple of tbw={tbw} "
            "(the TPU kernel's grid would leave the last windows unwritten)"
        )


def banded_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, win: int,
                           tbw: int) -> torch.Tensor:
    """Plain PyTorch version: windows of the map (reshape), the port's
    ``window_attention_plain``, back to NHWC. ``(B, Hp, Wp, C)`` in qkv's
    dtype."""
    _check_geometry(qkv, bias, win, tbw)
    B, Hp, Wp, C3 = qkv.shape
    q, k, v = _window_partition(qkv, win).split(C3 // 3, dim=-1)
    return _window_reverse(window_attention_plain(q, k, v, bias), win, B, Hp, Wp)


def band_window(n: int, nwh: int, nww: int) -> Tuple[int, int, int]:
    """Window ``n`` of the map as ``(b, i, j)``: image, window row, window
    column, row-major (``_window_partition``'s window order; the kernel's
    ``Banded::window``)."""
    b, r = divmod(n, nwh * nww)
    return (b, *divmod(r, nww))


def band_box(b: int, i: int, j: int, head: int, part: int, C: int, D: int,
             win: int) -> Tuple[int, int, int, int]:
    """The kernel's one TMA copy of tile ``part`` (0 q, 1 k, 2 v) of window
    ``(b, i, j)``, head ``head``: the box's coordinates ``(c0, x0, y0, b)``
    in the 4-D map ``(3C, Wp, Hp, B)`` over the NHWC qkv map (``csrc/
    window_band.cu::Banded``). The box is ``(D, win, win, 1)``."""
    return part * C + head * D, j * win, i * win, b


def box_rows(qkv: torch.Tensor, box: Tuple[int, int, int, int], D: int,
             win: int) -> torch.Tensor:
    """What the box copies, in the order it lands in shared memory:
    ``(win * win, D)``, row ``r`` the pixel ``(y0 + r // win, x0 + r %
    win)`` of image ``b``, channels ``c0 .. c0 + D``."""
    c0, x0, y0, b = box
    return qkv[b, y0:y0 + win, x0:x0 + win, c0:c0 + D].reshape(win * win, D)


def band_plan(B: int, Hp: int, Wp: int, win: int, heads: int, D: int, n_sms: int,
              blocks_per_sm: int) -> WindowPlan:
    """The kernel's grid: ``window_plan`` over the map's ``B * (Hp / win) *
    (Wp / win)`` windows with period 1 (no mask): block ``r * heads + h``
    takes run r of head h's windows, in ``band_window`` order."""
    n_windows = B * (Hp // win) * (Wp // win)
    return window_plan(n_windows, 1, heads, win * win, D, n_sms, blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _band_config(win: int, D: int, index: int) -> dict:
    lib = _build.library("window_band")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        err = lib.pixparse_window_band_config(win, D, ctypes.cast(out, ctypes.c_void_p))
    _build.check(err, "banded_attention config")
    keys = ("blocks_per_sm", "smem_bytes", "stages", "mask_slots", "bias_in_smem", "threads")
    return dict(zip(keys, list(out)))


def band_config(win: int, D: int, device) -> dict:
    """What one launch at window ``win`` and head dim ``D`` uses on
    ``device``: blocks per SM, dynamic shared memory, ring stages, threads
    per block (``window_config``'s keys)."""
    index = torch.device(device).index
    return _band_config(win, D, torch.cuda.current_device() if index is None else index)


def _banded_cuda(qkv, bias, win):
    B, Hp, Wp, C3 = qkv.shape
    heads = bias.shape[0]
    Dh = C3 // 3 // heads
    N = win * win
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"banded_attention: CUDA kernel takes bfloat16 qkv (got {qkv.dtype})")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"banded_attention: head dim {Dh} not in {HEAD_DIMS}")
    if N > MAX_WINDOW_TOKENS:
        raise ValueError(
            f"banded_attention: window {win} has {N} tokens (at most {MAX_WINDOW_TOKENS})")
    if not (bias.is_cuda and bias.device == qkv.device):
        raise ValueError("banded_attention: qkv and bias must be on one CUDA device")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("banded_attention: qkv must be contiguous and 16-byte aligned")
    ldb, nn = table_layout(N)
    bias_t = _tables(bias, N)
    index = qkv.device.index
    plan = band_plan(B, Hp, Wp, win, heads, Dh, _n_sms(index),
                     _band_config(win, Dh, index)["blocks_per_sm"])
    o = torch.empty((B, Hp, Wp, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library("window_band")
    with torch.cuda.device(qkv.device):
        err = lib.pixparse_window_band_fwd(
            _build.ptr(qkv), _build.ptr(bias_t), _build.ptr(o), B, Hp, Wp, win, heads, Dh, nn,
            ldb, plan.runs, float(Dh ** -0.5), _build.stream_ptr(qkv.device),
        )
    _build.check(err, "banded_attention")
    banded_attention.launches += 1
    return o


def banded_attention(qkv: torch.Tensor, bias: torch.Tensor, win: int, tbw: int) -> torch.Tensor:
    """Window attention on the NHWC qkv map ``(B, Hp, Wp, 3C)`` ->
    ``(B, Hp, Wp, C)``, per window and head ``softmax(q k^T Dh^-0.5 +
    bias[h]) v`` (no shift mask): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``launches`` counts calls that launched."""
    _check_geometry(qkv, bias, win, tbw)
    if qkv.is_cuda:
        return _banded_cuda(qkv, bias, win)
    return banded_attention_plain(qkv, bias, win, tbw)


banded_attention.launches = 0


def variant_current(h: torch.Tensor, wqkv: torch.Tensor, bias: torch.Tensor,
                    win: int) -> torch.Tensor:
    """Today's path: partition (a copy) -> projection -> kernel #14 ->
    reverse (a copy)."""
    B, Hp, Wp, C = h.shape
    qkv = _window_partition(h, win) @ wqkv  # (nB, ww, 3C)
    o = window_attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], bias)
    return _window_reverse(o, win, B, Hp, Wp)


def variant_banded(h: torch.Tensor, wqkv: torch.Tensor, bias: torch.Tensor, win: int,
                   tbw: int) -> torch.Tensor:
    """The same projection on the NHWC map, then kernel #17."""
    return banded_attention(h @ wqkv, bias, win, tbw)


def run(name: str, B: int, Hp: int, Wp: int, C: int, heads: int, win: int, tbw: int,
        iters: int = 30, device="cuda") -> Dict:
    """Parity of the two variants, their times, and the two kernels alone on
    the same windows (#17 on the map, #14 on its partitioned copy)."""
    rng = np.random.RandomState(0)
    ww = win * win
    # the JAX tool's inputs
    h, wqkv, bias = (torch.from_numpy(x.astype(np.float32)).to(device) for x in (
        rng.randn(B, Hp, Wp, C), rng.randn(C, 3 * C) * 0.02, rng.randn(heads, ww, ww) * 0.1))
    h, wqkv = h.bfloat16(), wqkv.bfloat16()

    o_cur = variant_current(h, wqkv, bias, win)
    o_band = variant_banded(h, wqkv, bias, win, tbw)
    diff = float((o_cur.float() - o_band.float()).abs().max())
    print(f"[{name}] parity max|diff| = {diff:.3e}", flush=True)
    rec = dict(name=name, shape=[B, Hp, Wp, C, heads, win, tbw], max_abs_diff=diff)
    rec["current_ms"] = event_ms(lambda: variant_current(h, wqkv, bias, win), iters)
    rec["banded_ms"] = event_ms(lambda: variant_banded(h, wqkv, bias, win, tbw), iters)
    print(f"[{name}] current: {rec['current_ms']:7.3f} ms", flush=True)
    print(f"[{name}] banded : {rec['banded_ms']:7.3f} ms", flush=True)

    qkv = h @ wqkv
    q, k, v = _window_partition(qkv, win).split(C, dim=-1)
    rec["band_kernel_ms"] = event_ms(lambda: banded_attention(qkv, bias, win, tbw), iters)
    rec["window_kernel_ms"] = event_ms(lambda: window_attention(q, k, v, bias), iters)
    print(f"[{name}] kernels alone: #17 banded {rec['band_kernel_ms']:7.3f} ms, "
          f"#14 window {rec['window_kernel_ms']:7.3f} ms", flush=True)
    print(f"[{name}] banded / current path {rec['banded_ms'] / rec['current_ms']:.3f}, "
          f"#17 / #14 {rec['band_kernel_ms'] / rec['window_kernel_ms']:.3f}", flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=[*GEOMETRIES, "all"])
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    recs = []
    with torch.inference_mode():
        for which, (name, *geometry, iters) in GEOMETRIES.items():
            if args.which in (which, "all"):
                recs.append(run(name, *geometry, iters=iters, device=device))
    return recs


if __name__ == "__main__":
    main()
