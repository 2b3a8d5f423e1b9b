"""Tensor-core contraction-width probe: the port's counterpart of the JAX
package's ``tools/mxu_probe.py`` (kernel #16, ``csrc/mxu_probe.cu``).

The port's attention kernels contract over the head dim, K = 64 for every
ViT and BART head. Question: does a K = 64 contraction run the tensor cores
at a lower rate than K = 128, and does slicing 64 columns out of a packed
128-wide buffer (as the window kernel reads q, k and v out of the fused qkv
rows) cost rate?

The probe computes, in fp32 from bf16 operands of ``SLABS`` = 32 slabs::

    o = sum over dots r of a[r % 32][:, c(r) : c(r) + K] @ b[r % 32][c(r) : c(r) + K, :]

in three variants that do the same useful work, 128·R multiply-adds for
every element of ``o``:

- ``k64``: 2R dots at K = 64, a ``(32, M, 64)``, b ``(32, 64, N)``, c = 0;
- ``k128``: R dots at K = 128, a ``(32, M, 128)``, b ``(32, 128, N)``, c = 0;
- ``k64x2``: 2R dots at K = 64 out of a ``(32, M, 128)`` and b
  ``(32, 128, N)``, c = 64·(r mod 2).

The TPU tool repeats the whole sum G times on its sequential grid. On the
card one persistent block per SM walks the (output tile, repeat) pairs
(:func:`probe_schedule`), and repeat g writes its own slab ``out[g]`` (all
equal). The kernel is ``wgmma`` fed by TMA through a 4-stage ring of
64-deep k-tiles (``csrc/mxu_probe.cu``), so the rates it prints are the
tensor cores' at each contraction width, and the packed slice is only a
TMA box coordinate. Its occupancy (blocks per SM) is printed beside the
rate. Useful TFLOP/s is ``2·G·R·M·N·128 / t``, the TPU tool's normalisation. The
yardstick, timed only, is one ``torch.matmul`` of the dot-ordered,
K-concatenated operands ``(M, 128·R) @ (128·R, N)`` batched over the G
repeats (stride-0 batch views: one copy of each operand).

Run on the card (importing this module runs nothing)::

    python -m pixparse_tpu_torch.tools.mxu_probe
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.tools import event_ms

M = 512
N = 256
R = 64  # dots of K = 128 per repeat (2R of K = 64)
G = 256  # repeats
SLABS = 32
# variant -> (buffer width W: a's columns and b's rows, one dot's depth K)
VARIANTS = {"k64": (64, 64), "k128": (128, 128), "k64x2": (128, 64)}
_CODES = {"k64": 0, "k128": 1, "k64x2": 2}
TILE = 128  # the kernel's output tile rows; M and N are multiples of it
MAX_REPEATS = 65535  # the kernel counts (tile, repeat) pairs in 32 bits


def n_dots(variant: str, dots: int = R) -> int:
    """Dots in one repeat: ``dots`` at K = 128, twice that at K = 64."""
    return dots * 128 // VARIANTS[variant][1]


def useful_flop(dots: int = R, repeats: int = G, m: int = M, n: int = N) -> float:
    """The TPU tool's normalisation: 2 FLOP per useful multiply-add."""
    return 2.0 * repeats * dots * m * n * 128


def _check(a, b, variant, dots, repeats):
    if variant not in VARIANTS:
        raise ValueError(f"mxu_dots: variant {variant!r} not in {sorted(VARIANTS)}")
    W, _ = VARIANTS[variant]
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != W \
            or b.shape[1] != W:
        raise ValueError(
            f"mxu_dots[{variant}]: a (S, M, {W}) and b (S, {W}, N) over the same S slabs "
            f"(got a {tuple(a.shape)}, b {tuple(b.shape)})"
        )
    if dots <= 0 or repeats <= 0:
        raise ValueError(f"mxu_dots: dots {dots} and repeats {repeats} must be positive")


def _slices(variant: str, slabs: int, dots: int):
    """(slab, first column) of every dot, in order."""
    W, K = VARIANTS[variant]
    return [(r % slabs, (r % 2) * K if W != K else 0) for r in range(n_dots(variant, dots))]


def tile_cols(n: int) -> int:
    """Columns of the kernel's output tile: 256 where N allows, else 128."""
    return 256 if n % 256 == 0 else TILE


def probe_schedule(m: int, n: int, repeats: int, n_sms: int,
                   blocks_per_sm: int = 1) -> List[List[Tuple[int, int, int]]]:
    """The persistent kernel's work on a card of ``n_sms`` SMs: for each
    block, the ``(repeat, m0, n0)`` of every (output tile, repeat) pair it
    computes, in order. The launch takes one wave, min(pairs, SMs x blocks
    per SM) blocks; pair p is tile ``p % tiles`` of repeat ``p // tiles``
    (tiles of ``TILE`` x ``tile_cols(n)``, row-major); block x takes pairs
    x, x + blocks, ... (``csrc/mxu_probe.cu::launch``, ``mxu_probe_kernel``)."""
    bn = tile_cols(n)
    tiles_n = n // bn
    tiles = (m // TILE) * tiles_n
    blocks = min(tiles * repeats, n_sms * blocks_per_sm)
    return [[(p // tiles, (p % tiles) // tiles_n * TILE, (p % tiles) % tiles_n * bn)
             for p in range(x, tiles * repeats, blocks)] for x in range(blocks)]


def mxu_dots_plain(a: torch.Tensor, b: torch.Tensor, variant: str, dots: int = R) -> torch.Tensor:
    """Plain PyTorch version: ``(M, N)`` fp32, a loop of fp32 matmuls over
    the same slices in the kernel's order of dots."""
    _check(a, b, variant, dots, 1)
    K = VARIANTS[variant][1]
    acc = torch.zeros(a.shape[1], b.shape[2], dtype=torch.float32, device=a.device)
    for s, c in _slices(variant, a.shape[0], dots):
        acc += a[s, :, c:c + K].float() @ b[s, c:c + K].float()
    return acc


def _mxu_cuda(a, b, variant, dots, repeats):
    S, m, _ = a.shape
    n = b.shape[2]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"mxu_dots: CUDA kernel takes bfloat16 a and b (got {a.dtype}, {b.dtype})")
    if not (b.is_cuda and b.device == a.device):
        raise ValueError("mxu_dots: a and b must be on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mxu_dots: a and b must be contiguous")
    if m % TILE or n % TILE:
        raise ValueError(f"mxu_dots: M {m} and N {n} must be multiples of {TILE}")
    if repeats > MAX_REPEATS:
        raise ValueError(f"mxu_dots: at most {MAX_REPEATS} repeats (got {repeats})")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mxu_dots: a and b must be 16-byte aligned")
    out = torch.empty((repeats, m, n), dtype=torch.float32, device=a.device)
    lib = _build.library("mxu_probe")
    with torch.cuda.device(a.device):
        err = lib.pixparse_mxu_probe(
            _CODES[variant], _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, S,
            n_dots(variant, dots), repeats, _build.stream_ptr(a.device),
        )
    _build.check(err, f"mxu_dots[{variant}]")
    mxu_dots.launches += 1
    return out


def mxu_dots(a: torch.Tensor, b: torch.Tensor, variant: str, dots: int = R,
             repeats: int = G) -> torch.Tensor:
    """``(repeats, M, N)`` fp32, every slab the sum: the CUDA kernel for CUDA
    tensors (bf16), the plain version for CPU tensors (computed once and
    expanded). ``launches`` counts calls that launched."""
    _check(a, b, variant, dots, repeats)
    if a.is_cuda:
        return _mxu_cuda(a, b, variant, dots, repeats)
    return mxu_dots_plain(a, b, variant, dots).expand(repeats, -1, -1)


mxu_dots.launches = 0


def operands(variant: str, device, m: int = M, n: int = N, seed: int = 0):
    """The TPU tool's operands: uniform [0, 1) from a numpy seed, bf16."""
    W, _ = VARIANTS[variant]
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.rand(SLABS, m, W).astype(np.float32))
    b = torch.from_numpy(rng.rand(SLABS, W, n).astype(np.float32))
    return a.to(device, torch.bfloat16), b.to(device, torch.bfloat16)


def library_operands(a, b, variant: str, dots: int = R, repeats: int = G):
    """The same sum as one batched product: the dots' slices concatenated
    along K in order, ``(repeats, M, n_dots·K) @ (repeats, n_dots·K, N)`` as
    stride-0 batch views of one copy each."""
    K = VARIANTS[variant][1]
    sl = _slices(variant, a.shape[0], dots)
    a_cat = torch.cat([a[s, :, c:c + K] for s, c in sl], dim=1)
    b_cat = torch.cat([b[s, c:c + K] for s, c in sl], dim=0)
    return a_cat.expand(repeats, -1, -1), b_cat.expand(repeats, -1, -1)


def blocks_per_sm(variant: str, device) -> int:
    """The kernel's occupancy in this variant: blocks that fit one SM."""
    with torch.cuda.device(device):
        n = _build.library("mxu_probe").pixparse_mxu_probe_blocks_per_sm(_CODES[variant])
    if n <= 0:
        raise RuntimeError(f"mxu_dots[{variant}]: occupancy query failed")
    return n


def run(variant: str, device, iters: int = 20) -> Dict:
    """Time the kernel at the tool's size and print its useful TFLOP/s."""
    a, b = operands(variant, device)
    ms = event_ms(lambda: mxu_dots(a, b, variant), iters)
    rec = dict(variant=variant, us=ms * 1e3, tflops=useful_flop() / (ms * 1e-3) / 1e12,
               blocks_per_sm=blocks_per_sm(variant, device))
    print(f"{variant:10s} {rec['us']:8.1f} us  useful {rec['tflops']:6.1f} TFLOP/s  "
          f"(blocks per SM: {rec['blocks_per_sm']})", flush=True)
    return rec


def run_library(device, iters: int = 20) -> Dict:
    """The yardstick: one ``torch.matmul`` over the same useful work."""
    a, b = operands("k128", device)
    a_rep, b_rep = library_operands(a, b, "k128")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    ms = event_ms(lambda: torch.matmul(a_rep, b_rep), iters)
    rec = dict(variant="matmul", us=ms * 1e3, tflops=useful_flop() / (ms * 1e-3) / 1e12,
               peak_extra_mib=(torch.cuda.max_memory_allocated(device) - base) / 2**20)
    print(f"{'matmul':10s} {rec['us']:8.1f} us  useful {rec['tflops']:6.1f} TFLOP/s", flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20, help="timed launches per variant")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}  M {M} N {N} R {R} G {G}", flush=True)
    with torch.inference_mode():
        recs = [run(v, device, args.iters) for v in VARIANTS]
        recs.append(run_library(device, args.iters))
    print("time over matmul: " + ", ".join(
        f"{r['variant']} {r['us'] / recs[-1]['us']:.3f}" for r in recs[:-1]), flush=True)
    return recs


if __name__ == "__main__":
    main()
