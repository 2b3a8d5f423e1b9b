"""Flash attention, forward and backward: CUDA kernels for Hopper and their
plain versions.

Counterpart of :mod:`pixparse_tpu.ops.flash_attention`. Layout
``(B, L, H, D)`` at the public functions, as in JAX. The kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``; in bf16
warp-specialised ``wgmma`` kernels fed by TMA, ``sm_90a`` only) read q/k/v
in place through their strides: any tensor whose last two dims ``(H, D)``
are contiguous works, e.g. the q/k/v views of a fused qkv projection, so no
head-split copy is made; gradients come back head-merged ``(B, L, H, D)``.
TMA takes a base address aligned to 16 bytes and row and batch strides that
are positive multiples of 16 bytes; the wrapper refuses other layouts with
``ValueError``.
:func:`flash_attention` is a :class:`torch.autograd.Function` over the two.

Semantics (both versions): fp32 scores and softmax, bottom-right causal
masking (query ``i`` sees keys ``<= i + Lk - Lq``), per-sample key lengths
``kv_lens``, p rounded to the value dtype before ``p @ v`` with the row sum
taken over the rounded p, and fully masked rows giving ``o = 0`` and
``lse = -1e30``.

Backward (both versions), from q, k, v, do, the forward's ``lse`` and
``delta = sum(do * o)`` per row (fp32, computed outside the kernels as in
JAX): ``p = exp(s - lse)`` rounded to the value dtype, ``dv = p^T do``,
``ds = p * (do v^T - delta) * scale`` rounded to the q dtype, ``dq = ds k``,
``dk = ds^T q``; ``lse`` is clamped at ``-0.5e30`` so fully masked rows give
``p = 0``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count wrapper calls that launched (the
backward's call launches its dK/dV and its dQ kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pixparse_tpu_torch.ops import _build

DEAD_LSE = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_causal_varlen(q, k, causal, kv_lens):
    if causal and kv_lens is not None and q.shape[1] != k.shape[1]:
        # the causal diagonal composes with the global offset Lk - Lq, not
        # per-sample lengths (same restriction as the JAX kernel)
        raise ValueError(
            "causal=True with kv_lens requires Lq == Lk "
            f"(got Lq={q.shape[1]}, Lk={k.shape[1]})"
        )


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: returns ``(o (B, Lq, H, D), lse (B, H, Lq))``.
    The semantics reference for the kernel."""
    _check_causal_varlen(q, k, causal, kv_lens)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    valid = _valid_mask(B, Lq, Lk, causal, kv_lens, q.device)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_use).to(v.dtype).float()  # rounded like the kernel
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / torch.where(live, l, 1.0)
    o = torch.where(live, o, 0.0).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(live, m_use + torch.log(torch.where(live, l, 1.0)), DEAD_LSE)
    return o.contiguous(), lse[..., 0]


def _operand_ok(t: torch.Tensor) -> bool:
    """(H, D) contiguous, a 16-byte aligned base, and row and batch strides
    that are positive multiples of 16 bytes (a stride of a dimension of size
    1 is never stepped): what the kernels' tensor maps read in place."""
    vec = 16 // t.element_size()
    return (
        t.stride(3) == 1
        and t.stride(2) == t.shape[3]
        and all(t.shape[i] <= 1 or (t.stride(i) > 0 and t.stride(i) % vec == 0) for i in (0, 1))
        and t.data_ptr() % 16 == 0
    )


def _check_operand(name: str, t: torch.Tensor):
    if not _operand_ok(t):
        raise ValueError(
            f"flash_attention: {name} must be contiguous over (H, D) with a "
            f"16-byte aligned base and positive row/batch strides that are "
            f"multiples of 16 bytes (got strides {tuple(t.stride())}, "
            f"base {t.data_ptr() % 16} bytes past 16-byte alignment)"
        )


def _flash_cuda(q, k, v, causal, kv_lens):
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: CUDA kernel takes bfloat16 or float32 q/k/v of "
            f"one dtype (got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, Lk, H, D) or v.shape != (B, Lk, H, D):
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_attention: kv_lens shape {tuple(lens.shape)} != ({B},)")
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    if B == 0 or Lq == 0:
        return o, lse
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pixparse_flash_attn_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(o), _build.ptr(lse), None if lens is None else _build.ptr(lens),
            B, H, Lq, Lk, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(causal), float(D ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (B, Lq, H, D), lse (B, H, Lq) fp32)``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``launches`` counts kernel
    launches."""
    _check_causal_varlen(q, k, causal, kv_lens)
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, kv_lens)
    return flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)


flash_attention_fwd.launches = 0


def _valid_mask(B, Lq, Lk, causal, kv_lens, device):
    col = torch.arange(Lk, device=device)
    valid = torch.ones((1, 1, Lq, Lk), dtype=torch.bool, device=device)
    if kv_lens is not None:
        valid = valid & (col[None, :] < kv_lens.to(device)[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(Lq, device=device)
        valid = valid & (col[None, :] <= row[:, None] + (Lk - Lq))
    return valid


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,  # (B, H, Lq) fp32, from the forward
    delta: torch.Tensor,  # (B, H, Lq) fp32, sum(do * o) per row
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` in the
    layouts and dtypes of q, k, v, with the kernels' rounding points."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid_mask(B, Lq, Lk, causal, kv_lens, q.device)
    lse_c = lse.clamp_min(0.5 * DEAD_LSE)[..., None]
    p = torch.where(valid, torch.exp(s - lse_c), 0.0).to(do.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_cuda(q, k, v, do, lse, delta, causal, kv_lens):
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == do.dtype == q.dtype):
        raise ValueError(
            f"flash_attention_bwd: CUDA kernel takes bfloat16 or float32 q/k/v/do of "
            f"one dtype (got {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype})"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, Lk, H, D) or v.shape != (B, Lk, H, D) or do.shape != q.shape:
        raise ValueError(
            f"flash_attention_bwd: shapes {q.shape} {k.shape} {v.shape} {do.shape}"
        )
    if not (k.is_cuda and v.is_cuda and do.is_cuda and lse.is_cuda and delta.is_cuda):
        raise ValueError("flash_attention_bwd: all operands must be on one CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, t)
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    if lse.shape != (B, H, Lq) or delta.shape != (B, H, Lq):
        raise ValueError(
            f"flash_attention_bwd: lse {tuple(lse.shape)} / delta {tuple(delta.shape)} "
            f"!= {(B, H, Lq)}"
        )
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_attention_bwd: kv_lens shape {tuple(lens.shape)} != ({B},)")
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or (Lq == 0 and Lk == 0):
        return dq, dk, dv
    lib = _build.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.pixparse_flash_attn_bwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(do), _build.ptr(lse), _build.ptr(delta),
            None if lens is None else _build.ptr(lens),
            _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
            B, H, Lq, Lk, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1),
            int(causal), float(D ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors. ``launches`` counts calls that launched the kernels."""
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, do, lse, delta, causal, kv_lens)
    return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal, kv_lens=kv_lens)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, kv_lens):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.kv_lens = kv_lens
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not _operand_ok(do):  # autograd may hand the cotangent over in another layout
            do = do.contiguous()
        # delta = sum(do * o) per (row, head), fp32, outside the kernels
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, do, lse, delta, causal=ctx.causal, kv_lens=ctx.kv_lens
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, H, D)
    v: torch.Tensor,  # (B, Lk, H, D)
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,  # (B,) valid key count per sample
) -> torch.Tensor:
    """Flash attention, JAX signature and layout; returns ``o`` only.
    Differentiable in q, k and v."""
    _check_causal_varlen(q, k, causal, kv_lens)
    return _FlashAttention.apply(q, k, v, causal, kv_lens)
