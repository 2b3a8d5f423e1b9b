"""LayerNorm with fp32 statistics (counterpart of
:mod:`pixparse_tpu.ops.layer_norm`).

The whole normalisation runs in fp32 and only the result is cast to the
input dtype. Two implementations, chosen as the JAX package chooses them:

- ``'xla'`` (the default, the JAX package's ``_ln_ref``): plain PyTorch
  under autograd;
- ``'pallas'`` (opt-in, ``PIXPARSE_LN_IMPL=pallas`` or ``impl='pallas'``, the
  JAX package's names): a :class:`torch.autograd.Function` over the CUDA
  kernels of ``csrc/layer_norm.cu`` (TPU kernels #12/#13). Both kernels are
  one wave of persistent blocks over row groups, cut alike
  (:func:`layer_norm_plan`, each with its own occupancy). The forward
  reads x once and writes y in x's dtype and saves no statistics; the
  backward recomputes them from x, writes dx in x's dtype and sums
  dweight/dbias over the rows in fp32: per-block partials, then a second
  pass in a fixed order (deterministic).

Beside the kernels stand :func:`layer_norm_fwd_plain` and
:func:`layer_norm_bwd_plain`, plain PyTorch with the kernels' math; a CPU
tensor takes them, a CUDA tensor launches the kernels or raises (a width the
kernels do not take raises too: D must be a multiple of 8 up to 8192).
``layer_norm_fwd.launches`` and ``layer_norm_bwd.launches`` count wrapper
calls that launched (the backward's call launches the row kernel and the
partial-sum kernel).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.ops import _build

IMPLS = ("xla", "pallas")
MAX_WIDTH = 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_ln_impl(impl: Optional[str] = None) -> str:
    """``impl``, or ``PIXPARSE_LN_IMPL`` when it is ``None`` (default
    ``'xla'``, the plain path)."""
    impl = os.environ.get("PIXPARSE_LN_IMPL", "xla") if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"LayerNorm impl {impl!r} (one of {IMPLS})")
    return impl


def layer_norm_fwd_plain(x, weight, bias, eps: float) -> torch.Tensor:
    """Plain version of the forward kernel: ``(R, D)`` -> y in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(
    x, weight, dy, eps: float, row_ranges: Optional[List[Tuple[int, int]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(dx in x's dtype, dweight
    fp32, dbias fp32)``, statistics recomputed from x. With ``row_ranges``
    (:func:`layer_norm_bwd_row_ranges`) dweight/dbias are summed as the
    kernels sum them: one partial per block's range of rows, then partial
    ``w, w + 32, ...`` in order for w < 32, then those 32 sums in order."""
    xf, g = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxh = g * weight.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxh - m1 - xhat * m2)
    if row_ranges is None:
        return dx.to(x.dtype), (g * xhat).sum(0), g.sum(0)
    parts = torch.stack([torch.cat([(g[lo:hi] * xhat[lo:hi]).sum(0), g[lo:hi].sum(0)])
                         for lo, hi in row_ranges])
    sums = torch.zeros_like(parts[0])
    for w in range(LN_SUM_WARPS):
        sw = torch.zeros_like(parts[0])
        for part in parts[w::LN_SUM_WARPS]:
            sw = sw + part
        sums = sums + sw
    D = x.shape[1]
    return dx.to(x.dtype), sums[:D], sums[D:]


LN_THREADS = 256  # both kernels' blocks
LN_SUM_WARPS = 32  # the partial-sum kernel's warps


def layer_norm_config(D: int, elt: int) -> Tuple[int, int, int]:
    """Both kernels' ``(TR, K, U)`` for width D and element size ``elt``: a
    row takes TR threads (D / 8 rounded up to a power of two, at most 32,
    doubled while a thread would hold more than 2 chunks of 8, up to 256),
    each K chunks (K = 4 beyond); each thread takes U rows of a group at once
    (``U * K <= 4`` in bf16, 2 in fp32)."""
    n = D // 8
    tr = 1
    while tr < n and tr < 32:
        tr *= 2
    while -(-n // tr) > 2 and tr < 256:
        tr *= 2
    k = -(-n // tr)
    if tr == 256 and k > 2:
        k = 4
    return tr, k, max(1, (4 if elt == 2 else 2) // k)


@functools.lru_cache(maxsize=256)
def layer_norm_plan(R: int, D: int, elt: int, sm_count: int,
                    blocks_per_sm: int) -> Tuple[int, int, int]:
    """``(G, n_groups, n_blocks)``: rows go in groups of ``G = (256 / TR) *
    U`` consecutive rows (the backward's unit of one bulk copy of x and of
    dy), and one wave of at most ``sm_count * blocks_per_sm`` persistent
    blocks (the kernel's own occupancy) takes the groups
    (:func:`layer_norm_bwd_row_ranges`, :func:`layer_norm_fwd_groups`): as
    few blocks as give each the most groups any block must take (fewer
    partials to sum, no later finish)."""
    tr, _, u = layer_norm_config(D, elt)
    G = (LN_THREADS // tr) * u
    n_groups = -(-R // G)
    rounds = -(-n_groups // (sm_count * blocks_per_sm))
    return G, n_groups, -(-n_groups // rounds)


def layer_norm_bwd_row_ranges(R: int, G: int, n_groups: int, n_blocks: int) -> List[Tuple[int, int]]:
    """The backward's block i takes rows of groups ``[n_groups * i //
    n_blocks, n_groups * (i + 1) // n_blocks)``, as the kernel cuts them."""
    return [(min(R, n_groups * i // n_blocks * G), min(R, n_groups * (i + 1) // n_blocks * G))
            for i in range(n_blocks)]


def layer_norm_fwd_groups(n_groups: int, n_blocks: int, i: int) -> range:
    """The forward's block i takes groups ``i, i + n_blocks, ...``, as the
    kernel walks them (at any moment the blocks read one stretch of x)."""
    return range(i, n_groups, n_blocks)



@functools.lru_cache(maxsize=None)
def _blocks_per_sm(direction: str, device_index: int, dtype_code: int, D: int) -> int:
    lib = _build.library("layer_norm")
    with torch.cuda.device(device_index):
        n = getattr(lib, f"pixparse_layer_norm_{direction}_blocks_per_sm")(dtype_code, D)
    if n <= 0:
        raise RuntimeError(f"layer_norm_{direction}: occupancy query failed")
    return n


@functools.lru_cache(maxsize=1024)
def _fwd_blocks(device_index: int, dtype_code: int, elt: int, R: int, D: int) -> int:
    """The forward's block count, per (device, dtype, R, D): the plan once."""
    return layer_norm_plan(R, D, elt, _sm_count(device_index),
                           _blocks_per_sm("fwd", device_index, dtype_code, D))[2]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(name, x, *others):
    R, D = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: CUDA kernels take bfloat16 or float32 rows (got {x.dtype})")
    if D % 8 or not 0 < D <= MAX_WIDTH:
        raise ValueError(f"{name}: width {D} is not a multiple of 8 in 8..{MAX_WIDTH}")
    if not all(t.is_cuda and t.device == x.device for t in others):
        raise ValueError(f"{name}: all operands must be on one CUDA device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """``(R, D)`` -> y: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_fwd_plain(x, weight, bias, eps)
    _check("layer_norm_fwd", x, weight, bias)
    # rows, w and b are read as 16-byte vectors
    x, w, b = (_aligned(t.contiguous()) for t in (x, weight.to(torch.float32), bias.to(torch.float32)))
    y = torch.empty_like(x)
    R, D = x.shape
    code = _DTYPE_CODES[x.dtype]
    n_blocks = _fwd_blocks(x.device.index or 0, code, x.element_size(), R, D) if R else 0
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        err = lib.pixparse_layer_norm_fwd(
            code, _build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(y),
            R, D, n_blocks, float(eps), _build.stream_ptr(x.device),
        )
    _build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float):
    """``(dx, dweight, dbias)``: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_bwd_plain(x, weight, dy, eps)
    _check("layer_norm_bwd", x, weight, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} vs x {tuple(x.shape)}")
    # row groups are bulk copies: 16-byte aligned
    x, dy = _aligned(x.contiguous()), _aligned(dy.contiguous())
    w = _aligned(weight.to(torch.float32).contiguous())  # read as 16-byte vectors
    R, D = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    db = torch.empty(D, dtype=torch.float32, device=x.device)
    if R == 0:
        return dx, dw.zero_(), db.zero_()
    dev = x.device.index or 0
    code = _DTYPE_CODES[x.dtype]
    _, _, n_blocks = layer_norm_plan(
        R, D, x.element_size(), _sm_count(dev), _blocks_per_sm("bwd", dev, code, D))
    partial = torch.empty((n_blocks, 2, D), dtype=torch.float32, device=x.device)
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        err = lib.pixparse_layer_norm_bwd(
            code, _build.ptr(x), _build.ptr(w), _build.ptr(dy), _build.ptr(dx),
            _build.ptr(partial), _build.ptr(dw), _build.ptr(db), R, D, n_blocks, float(eps),
            _build.stream_ptr(x.device),
        )
    _build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        ctx.save_for_backward(x2, weight)
        ctx.eps = eps
        return layer_norm_fwd(x2, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, weight, dy.to(x2.dtype), ctx.eps)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def layer_norm(
    x: torch.Tensor,  # (..., D)
    weight: torch.Tensor,  # (D,)
    bias: torch.Tensor,  # (D,)
    eps: float = 1e-6,
    impl: Optional[str] = None,  # None = PIXPARSE_LN_IMPL, default 'xla'
) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 stats, output in ``x.dtype``."""
    if resolve_ln_impl(impl) == "xla":
        y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
        return y.to(x.dtype)
    D = x.shape[-1]
    return _LayerNorm.apply(x.reshape(-1, D), weight, bias, float(eps)).reshape(x.shape)


class LayerNorm(nn.Module):
    """Drop-in for ``nn.LayerNorm`` (same ``weight``/``bias`` names) that
    routes through :func:`layer_norm`: the plain path by default, the kernels
    under ``PIXPARSE_LN_IMPL=pallas``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
