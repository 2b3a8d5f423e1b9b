"""LayerNorm with fp32 statistics (counterpart of
:mod:`pixparse_tpu.ops.layer_norm`).

The whole normalisation runs in fp32 and only the result is cast to the
input dtype. Two implementations, chosen as the JAX package chooses them:

- ``'xla'`` (the default, the JAX package's ``_ln_ref``): plain PyTorch
  under autograd;
- ``'pallas'`` (opt-in, ``PIXPARSE_LN_IMPL=pallas`` or ``impl='pallas'``, the
  JAX package's names): a :class:`torch.autograd.Function` over the CUDA
  kernels of ``csrc/layer_norm.cu`` (TPU kernels #12/#13). The forward reads
  x once and writes y in x's dtype and saves no statistics; the backward
  recomputes them from x, writes dx in x's dtype and sums dweight/dbias over
  the rows in fp32 (per-block partials, then a second pass: deterministic).

Beside the kernels stand :func:`layer_norm_fwd_plain` and
:func:`layer_norm_bwd_plain`, plain PyTorch with the kernels' math; a CPU
tensor takes them, a CUDA tensor launches the kernels or raises (a width the
kernels do not take raises too: D must be a multiple of 8 up to 8192).
``layer_norm_fwd.launches`` and ``layer_norm_bwd.launches`` count wrapper
calls that launched (the backward's call launches the row kernel and the
partial-sum kernel).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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


def layer_norm_bwd_plain(x, weight, dy, eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(dx in x's dtype, dweight
    fp32, dbias fp32)``, statistics recomputed from x."""
    xf, g = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxh = g * weight.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxh - m1 - xhat * m2)
    return dx.to(x.dtype), (g * xhat).sum(0), g.sum(0)


def _check(name, x, *others):
    R, D = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: CUDA kernels take bfloat16 or float32 rows (got {x.dtype})")
    if D % 8 or not 0 < D <= MAX_WIDTH:
        raise ValueError(f"{name}: width {D} is not a multiple of 8 in 8..{MAX_WIDTH}")
    if not all(t.is_cuda and t.device == x.device for t in others):
        raise ValueError(f"{name}: all operands must be on one CUDA device")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """``(R, D)`` -> y: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_fwd_plain(x, weight, bias, eps)
    _check("layer_norm_fwd", x, weight, bias)
    x = x.contiguous()
    w = weight.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    R, D = x.shape
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        err = lib.pixparse_layer_norm_fwd(
            _DTYPE_CODES[x.dtype], _build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(y),
            R, D, float(eps), _build.stream_ptr(x.device),
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
    x, dy = x.contiguous(), dy.contiguous()
    w = weight.to(torch.float32).contiguous()
    R, D = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    db = torch.empty(D, dtype=torch.float32, device=x.device)
    if R == 0:
        return dx, dw.zero_(), db.zero_()
    lib = _build.library("layer_norm")
    n_blocks = lib.pixparse_layer_norm_bwd_blocks(R)
    partial = torch.empty((n_blocks, 2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pixparse_layer_norm_bwd(
            _DTYPE_CODES[x.dtype], _build.ptr(x), _build.ptr(w), _build.ptr(dy), _build.ptr(dx),
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
