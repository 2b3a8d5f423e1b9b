"""Swin window attention: a CUDA kernel for Hopper and its plain version.

Counterpart of :func:`pixparse_tpu.ops.window_attention.window_attention`
(forward only). Per window and head::

    softmax(q k^T * Dh^-0.5 + bias[h] + mask[w % nW]) v

with q/k/v ``(nB, ww, C)``, ``C = H * Dh``, heads flat in the channels;
``bias`` ``(H, ww, ww)`` and ``mask`` ``(nW, ww, ww)`` fp32. Windows are
ordered ``b * nW + w`` (``models/swin.py::_window_partition``), so the mask
repeats with period ``nW``. The scale multiplies the fp32 product before
the bias is added, the softmax runs in fp32 and p is rounded to the input
dtype before ``p v``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (``csrc/window_attention.cu``) or raises. ``window_attention.launches``
counts kernel launches. The backward (TPU kernel #15,
``ops/window_attention.py::_bwd_kernel``) is not ported: a CUDA input that
requires grad raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from pixparse_tpu_torch.ops import _build

HEAD_DIMS = (16, 32, 64)
MAX_WINDOW_TOKENS = 144  # window 12
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, bias, mask):
    """The JAX function's checks, with its messages."""
    heads = bias.shape[0]
    if mask is not None and q.shape[0] % mask.shape[0]:
        raise ValueError(
            f"window count {q.shape[0]} not a multiple of mask period {mask.shape[0]}"
        )
    if q.shape[-1] % heads:
        raise ValueError(f"C={q.shape[-1]} not divisible by heads={heads}")


def window_attention_plain(q, k, v, bias, mask=None) -> torch.Tensor:
    """Plain PyTorch version: the XLA branch of the JAX ``WindowAttention``
    (``models/swin.py``), inlined. Returns ``(nB, ww, C)`` in q's dtype."""
    _check_args(q, bias, mask)
    nB, N, C = q.shape
    H = bias.shape[0]
    Dh = C // H
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.reshape(nB, N, H, Dh).float(), k.reshape(nB, N, H, Dh).float()
    ) * Dh ** -0.5
    s = s + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(nB // nW, nW, H, N, N) + mask.float()[None, :, None]).reshape(nB, H, N, N)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.reshape(nB, N, H, Dh).float())
    return o.reshape(nB, N, C).to(q.dtype)


def _rows_ok(t: torch.Tensor) -> bool:
    """Channels contiguous, 16-byte aligned rows: what the kernel reads in
    place (q/k/v may be column slices of the fused qkv projection)."""
    vec = 16 // t.element_size()
    return (
        t.stride(2) == 1
        and t.stride(1) % vec == 0
        and t.stride(0) % vec == 0
        and t.data_ptr() % 16 == 0
    )


def _window_cuda(q, k, v, bias, mask):
    nB, N, C = q.shape
    H = bias.shape[0]
    Dh = C // H
    if any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "window_attention: the backward (TPU kernel #15, "
            "pixparse_tpu/ops/window_attention.py::_bwd_kernel) is not ported; "
            "run the CUDA forward under torch.no_grad() or torch.inference_mode()"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"window_attention: CUDA kernel takes bfloat16 or float32 q/k/v of one "
            f"dtype (got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if Dh not in HEAD_DIMS:
        raise ValueError(f"window_attention: head dim {Dh} not in {HEAD_DIMS}")
    if not 0 < N <= MAX_WINDOW_TOKENS:
        raise ValueError(f"window_attention: {N} tokens per window (1..{MAX_WINDOW_TOKENS})")
    if k.shape != q.shape or v.shape != q.shape or bias.shape != (H, N, N):
        raise ValueError(
            f"window_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} bias {tuple(bias.shape)}"
        )
    if mask is not None and mask.shape[1:] != (N, N):
        raise ValueError(f"window_attention: mask shape {tuple(mask.shape)}")
    tensors = (q, k, v, bias) + (() if mask is None else (mask,))
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("window_attention: all operands must be on one CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_ok(t):
            raise ValueError(
                f"window_attention: {name} must have contiguous, 16-byte aligned "
                f"rows (got strides {tuple(t.stride())})"
            )
    bias = bias.to(torch.float32).contiguous()
    n_period = 1
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
        n_period = mask.shape[0]
    o = torch.empty((nB, N, C), dtype=q.dtype, device=q.device)
    if nB == 0:
        return o
    lib = _build.library("window_attention")
    with torch.cuda.device(q.device):
        err = lib.pixparse_window_attn_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(bias), None if mask is None else _build.ptr(mask), _build.ptr(o),
            nB, n_period, N, H, Dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(Dh ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "window_attention")
    window_attention.launches += 1
    return o


def window_attention(
    q: torch.Tensor,  # (nB, ww, C), nB = batch * windows per image, C = H * Dh
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, ww, ww) relative-position bias
    mask: Optional[torch.Tensor] = None,  # (nW, ww, ww) shift mask
) -> torch.Tensor:
    """Fused per-window attention -> ``(nB, ww, C)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_args(q, bias, mask)
    if q.is_cuda:
        return _window_cuda(q, k, v, bias, mask)
    return window_attention_plain(q, k, v, bias, mask)


window_attention.launches = 0
