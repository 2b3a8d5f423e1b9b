"""Single-token decode attention over flat KV caches: a CUDA kernel for
Hopper and its plain version.

Counterpart of :func:`pixparse_tpu.ops.decode_attention.decode_attention`
(the bf16 path; the int8 caches and ``quantize_*`` arrive with their own
slice). q ``(B, 1, H*D)``, k/v ``(B, Lk, H*D)`` caches stored flat, mask
``(B, Lk)`` (> 0 / True = attend). Fully masked rows give zeros.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (``csrc/decode_attention.cu``) or raises.
"""

from __future__ import annotations

import functools

import torch

from pixparse_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q, k, v, mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version (the TPU kernel's math: masked fp32 softmax,
    dead rows -> 0, p cast to the cache dtype before ``p @ v``)."""
    B, _, HD = q.shape
    Lk = k.shape[1]
    H = num_heads
    D = HD // H
    s = torch.einsum(
        "bhd,bkhd->bhk", q.reshape(B, H, D).float(), k.reshape(B, Lk, H, D).float()
    ) * D ** -0.5
    valid = (mask > 0)[:, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= NEG_INF * 0.5
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = torch.where(dead, 0.0, p / torch.where(l == 0.0, 1.0, l))
    o = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype).float(), v.reshape(B, Lk, H, D).float())
    return o.to(q.dtype).reshape(B, 1, HD)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(batch_heads: int, Lk: int, sm_count: int) -> int:
    """Key splits per (sample, head): enough blocks for ~4 per SM, at least
    64 keys per split."""
    want = -(-4 * sm_count // max(batch_heads, 1))
    return max(1, min(want, -(-Lk // 64)))


def _decode_cuda(q, k, v, mask, num_heads):
    B, _, HD = q.shape
    Lk = k.shape[1]
    H = num_heads
    if HD % H:
        raise ValueError(f"decode_attention: width {HD} not divisible by {H} heads")
    D = HD // H
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"decode_attention: CUDA kernel takes bfloat16 or float32 q/k/v of "
            f"one dtype (got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if q.shape != (B, 1, HD) or k.shape != (B, Lk, HD) or v.shape != (B, Lk, HD):
        raise ValueError(f"decode_attention: shapes {q.shape} {k.shape} {v.shape}")
    if mask.shape != (B, Lk):
        raise ValueError(f"decode_attention: mask shape {tuple(mask.shape)} != ({B}, {Lk})")
    if not (k.is_cuda and v.is_cuda and mask.is_cuda):
        raise ValueError("decode_attention: q, k, v and mask must be on one CUDA device")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (
            t.stride(2) != 1
            or t.stride(0) % vec
            or (t.shape[1] > 1 and t.stride(1) % vec)
            or t.data_ptr() % 16
        ):
            raise ValueError(
                f"decode_attention: {name} must have contiguous, 16-byte aligned "
                f"rows (got strides {tuple(t.stride())})"
            )
    if mask.dtype != torch.bool:
        mask = mask > 0
    if mask.stride(1) != 1:
        raise ValueError("decode_attention: mask rows must be contiguous")
    o = torch.empty((B, 1, HD), dtype=q.dtype, device=q.device)
    if B == 0:
        return o
    n_split = num_splits(B * H, Lk, _sm_count(q.device.index or 0))
    work = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attention")
    with torch.cuda.device(q.device):
        err = lib.pixparse_decode_attn_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(mask), _build.ptr(o), _build.ptr(work),
            B, H, Lk, D,
            q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1), mask.stride(0),
            n_split, float(D ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


def decode_attention(
    q: torch.Tensor,     # (B, 1, H*D) single-position queries, heads flat
    k: torch.Tensor,     # (B, Lk, H*D) flat key cache
    v: torch.Tensor,     # (B, Lk, H*D) flat value cache
    mask: torch.Tensor,  # (B, Lk) True/nonzero = attend
    num_heads: int,
) -> torch.Tensor:
    """Single-token decode attention -> ``(B, 1, H*D)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. ``launches`` counts
    kernel launches."""
    if q.is_cuda:
        return _decode_cuda(q, k, v, mask, num_heads)
    return decode_attention_plain(q, k, v, mask, num_heads)


decode_attention.launches = 0
