"""Attention entry point (counterpart of :mod:`pixparse_tpu.ops.attention`).

Layout ``(batch, length, heads, head_dim)``. ``impl='xla'`` is the plain
PyTorch attention (the name is kept so flags and configs carry over);
``impl='flash'`` dispatches to :func:`~pixparse_tpu_torch.ops.flash_attention.flash_attention`
when no additive bias is given.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

_logger = logging.getLogger(__name__)

NEG_MIN = torch.finfo(torch.float32).min


def mask_lens(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Key validity mask ``(B, N)`` whose real keys come first (the
    pix2struct patchifier packs them so) -> ``(B,)`` int32 valid counts,
    the ``kv_lens`` of :func:`dot_product_attention`."""
    return None if mask is None else mask.sum(-1, dtype=torch.int32)


def dot_product_attention(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, H, D)
    v: torch.Tensor,  # (B, Lk, H, D)
    bias: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Lq, Lk)
    causal: bool = False,
    dtype: Optional[torch.dtype] = None,
    impl: str = "xla",
    kv_lens: Optional[torch.Tensor] = None,  # (B,) leading valid key count
) -> torch.Tensor:
    """Scaled dot-product attention, scores and softmax in fp32.

    ``kv_lens`` masks trailing key positions per sample; the plain path
    lowers it to a ``finfo(float32).min`` bias, so a row with no valid key
    averages v uniformly, exactly as the JAX XLA path does (the flash path
    gives zeros there). Mutually exclusive with ``bias``."""
    if bias is not None and kv_lens is not None:
        raise ValueError("bias and kv_lens are mutually exclusive")
    if impl == "flash":
        if bias is None:
            from pixparse_tpu_torch.ops.flash_attention import flash_attention

            return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens)
        _logger.warning(
            "impl='flash' requested but an additive bias forces the plain "
            "attention path (shape q=%s bias=%s); pass kv_lens for "
            "flash-compatible masking", tuple(q.shape), tuple(bias.shape),
        )
    if kv_lens is not None:
        valid = torch.arange(k.shape[1], device=k.device)[None, :] < kv_lens[:, None]
        bias = torch.where(valid[:, None, None, :], 0.0, NEG_MIN)

    out_dtype = dtype or q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        row = torch.arange(lq, device=q.device)[:, None]
        col = torch.arange(lk, device=q.device)[None, :]
        scores = torch.where(row + (lk - lq) >= col, scores, NEG_MIN)
    weights = torch.softmax(scores, dim=-1).to(out_dtype)
    ct = torch.promote_types(out_dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(ct), v.to(ct))


def make_attention_bias(
    pad_mask: Optional[torch.Tensor],  # (B, Lk) True = attend
    dtype: torch.dtype = torch.float32,
) -> Optional[torch.Tensor]:
    """Additive key-padding bias ``(B, 1, 1, Lk)``: 0 where ``pad_mask`` is
    True, ``finfo(float32).min`` elsewhere, cast to ``dtype``."""
    if pad_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=pad_mask.device)
    neg = torch.full((), NEG_MIN, dtype=torch.float32, device=pad_mask.device)
    return torch.where(pad_mask[:, None, None, :], zero, neg).to(dtype)
