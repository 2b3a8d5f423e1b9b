"""Flash attention forward: a CUDA kernel for Hopper and its plain version.

Counterpart of :mod:`pixparse_tpu.ops.flash_attention` (forward only; the
backward kernels arrive with the training slice). Layout ``(B, L, H, D)``
at the public functions, as in JAX. The kernel
(``csrc/flash_attention.cu``) reads q/k/v in place through their strides:
any tensor whose last two dims ``(H, D)`` are contiguous works, e.g. the
q/k/v views of a fused qkv projection, so no head-split copy is made.

Semantics (both versions): fp32 scores and softmax, bottom-right causal
masking (query ``i`` sees keys ``<= i + Lk - Lq``), per-sample key lengths
``kv_lens``, p rounded to the value dtype before ``p @ v`` with the row sum
taken over the rounded p, and fully masked rows giving ``o = 0`` and
``lse = -1e30``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
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
    col = torch.arange(Lk, device=q.device)
    valid = torch.ones((1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if kv_lens is not None:
        valid = valid & (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(Lq, device=q.device)
        valid = valid & (col[None, :] <= row[:, None] + (Lk - Lq))
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


def _check_operand(name: str, t: torch.Tensor, D: int, vec: int):
    ok = (
        t.stride(3) == 1
        and t.stride(2) == D
        and t.stride(1) % vec == 0
        and t.stride(0) % vec == 0
        and t.data_ptr() % 16 == 0
    )
    if not ok:
        raise ValueError(
            f"flash_attention: {name} must be contiguous over (H, D) with "
            f"16-byte aligned rows (got strides {tuple(t.stride())})"
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
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, D, vec)
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


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, H, D)
    v: torch.Tensor,  # (B, Lk, H, D)
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,  # (B,) valid key count per sample
) -> torch.Tensor:
    """Flash attention, JAX signature and layout; returns ``o`` only."""
    return flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)[0]
