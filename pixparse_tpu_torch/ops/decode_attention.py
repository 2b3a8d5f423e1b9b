"""Single-token decode attention over flat KV caches: CUDA kernels for
Hopper and their plain versions.

Counterpart of :mod:`pixparse_tpu.ops.decode_attention`. q ``(B, 1, H*D)``,
k/v ``(B, Lk, H*D)`` caches stored flat, mask ``(B, Lk)`` (> 0 / True =
attend). Fully masked rows give zeros.

- :func:`decode_attention`: caches in the compute dtype, each row H*D
  contiguous elements (``csrc/decode_attention.cu``: a block per sample
  and key split over all heads, planned by :func:`decode_plan`).
- :func:`decode_attention_q8`: int8 caches with per-(sample, head,
  position) fp32 scales from :func:`quantize_kv_rows`
  (``csrc/decode_attention_q8.cu``). The query and the rows
  ``p * v_scale`` are quantized per head inside, and both products are
  exact int32 sums. The scales are kept ``(B, H, Lk)``: the JAX package
  pads the head axis to a multiple of 8 for the TPU's sublanes, a layout
  the card does not need.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper's ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from pixparse_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
Q8_MAX_KEYS = 32768  # the q8 kernel keeps a head's whole score row in shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_softmax_rows(s, mask):
    """(B, H, Lk) fp32 scores + (B, Lk) validity -> probabilities; fully
    masked rows give zeros (the rule both TPU decode kernels share)."""
    s = torch.where((mask > 0)[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= NEG_INF * 0.5
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.where(dead, 0.0, p / torch.where(l == 0.0, 1.0, l))


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
    p = _masked_softmax_rows(s, mask)
    o = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype).float(), v.reshape(B, Lk, H, D).float())
    return o.to(q.dtype).reshape(B, 1, HD)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


DECODE_TILE_BYTES = 16384  # one stage's K (or V) tile in the kernel's ring
DECODE_MAX_TILE_KEYS = 64
DECODE_MAX_SPLIT_KEYS = 8192  # a split's mask bytes sit in shared memory
DECODE_MAX_ROW_BYTES = 4096  # H*D*elt: one thread owns 16 bytes of a row


def decode_plan(B: int, Lk: int, row_bytes: int, sm_count: int) -> Tuple[int, int, int]:
    """The kernel's work split: ``(kt, split_keys, n_split)``. A block owns
    one (sample, split) of ``split_keys`` keys over all heads and streams it
    in tiles of ``kt`` keys (a tile of K holds about ``DECODE_TILE_BYTES``,
    at most ``DECODE_MAX_TILE_KEYS`` keys). The splits give about two blocks
    per SM (``B * n_split ~ 2 * sm_count``) and hold whole tiles; the
    ``n_split`` splits cover ``Lk``."""
    kt = max(1, min(DECODE_MAX_TILE_KEYS, DECODE_TILE_BYTES // row_bytes))
    want = -(-2 * sm_count // max(B, 1))
    split = -(-max(Lk, 1) // want)
    split = min(-(-split // kt) * kt, DECODE_MAX_SPLIT_KEYS // kt * kt)
    return kt, split, max(1, -(-Lk // split))


_SPLIT_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _split_counters(device: torch.device, stream, B: int) -> torch.Tensor:
    """The kernel's per-sample counters of finished splits: zeros, and each
    launch leaves them zero. One buffer per (device, stream): launches on
    one stream never overlap, so they share it."""
    key = (device.index, stream.cuda_stream)
    c = _SPLIT_COUNTERS.get(key)
    if c is None or c.numel() < B:
        c = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[key] = c
    return c


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
    elt = q.element_size()
    if HD * elt > DECODE_MAX_ROW_BYTES:
        raise ValueError(
            f"decode_attention: rows of {HD * elt} bytes (H*D = {HD}); the kernel "
            f"takes at most {DECODE_MAX_ROW_BYTES}"
        )
    vec = 16 // elt
    if q.stride(2) != 1 or q.stride(0) % vec or q.data_ptr() % 16:
        raise ValueError(
            f"decode_attention: q must have contiguous, 16-byte aligned rows "
            f"(got strides {tuple(q.stride())})"
        )
    for name, t in (("k", k), ("v", v)):
        # a key tile is one contiguous run of whole rows (a 1-D bulk copy)
        if (
            t.stride(2) != 1
            or (Lk > 1 and t.stride(1) != HD)
            or t.stride(0) % vec
            or t.data_ptr() % 16
        ):
            raise ValueError(
                f"decode_attention: {name} must be stored (B, Lk, H*D) with "
                f"contiguous rows of H*D elements, 16-byte aligned (got strides "
                f"{tuple(t.stride())})"
            )
    if mask.dtype != torch.bool:
        mask = mask > 0
    if mask.stride(1) != 1:
        raise ValueError("decode_attention: mask rows must be contiguous")
    o = torch.empty((B, 1, HD), dtype=q.dtype, device=q.device)
    if B == 0:
        return o
    kt, split_keys, n_split = decode_plan(B, Lk, HD * elt, _sm_count(q.device.index or 0))
    work = torch.empty(B * n_split * (HD + 2 * H), dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        counters = _split_counters(q.device, stream, B)
        err = lib.pixparse_decode_attn_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(mask), _build.ptr(o), _build.ptr(work), _build.ptr(counters),
            B, H, Lk, D,
            q.stride(0), k.stride(0), v.stride(0), mask.stride(0), kt, split_keys, n_split,
            float(D ** -0.5), ctypes.c_void_p(stream.cuda_stream),
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


# --------------------------------------------------------------------------
# int8 caches
# --------------------------------------------------------------------------


def quantize_int8_rows(x: torch.Tensor, dim: int):
    """Symmetric absmax int8 quantization along ``dim`` -> ``(x_i8, scales)``
    (scales keep ``dim`` with size 1). An all-zero row gets scale 1.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    am = x.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: on the card, dividing by a Python number multiplies
    # by its reciprocal, which is not always the correctly rounded quotient
    scales = torch.where(am > 0, am, 127.0) / x.new_tensor(127.0)
    return torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8), scales


def quantize_kv_rows(x: torch.Tensor, num_heads: int):
    """Per-(sample, position, head) int8 quantization of a flat
    ``(B, L, H*D)`` cache tensor -> ``(x_i8 (B, L, H*D) int8, scales
    (B, H, L) fp32)``."""
    B, L, HD = x.shape
    x_i8, scales = quantize_int8_rows(x.float().reshape(B, L, num_heads, HD // num_heads), -1)
    return x_i8.reshape(B, L, HD), scales[..., 0].transpose(1, 2).contiguous()


def decode_attention_q8_plain(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads: int):
    """Plain PyTorch version of the int8 kernel (the TPU kernel's math): q
    quantized per head; ``q_i8 . k_i8`` summed exactly, then scaled by
    ``qscale * (k_scale * Dh^-0.5)``; the masked softmax; ``p * v_scale``
    quantized per head over the whole row; ``pv_i8 . v_i8`` summed exactly,
    then scaled. The integer sums run in float64, exact for them (the card
    has no integer einsum), like the kernel's int32."""
    B, _, HD = q.shape
    Lk = k_i8.shape[1]
    H = num_heads
    D = HD // H
    q_i8, qscale = quantize_int8_rows(q.float().reshape(B, H, D), -1)  # (B, H, D), (B, H, 1)
    raw = torch.einsum("bhd,bkhd->bhk", q_i8.double(), k_i8.reshape(B, Lk, H, D).double())
    s = (raw.float() * qscale) * (k_scale[:, :H].float() * D ** -0.5)
    pv = _masked_softmax_rows(s, mask) * v_scale[:, :H].float()
    pv_i8, pscale = quantize_int8_rows(pv, -1)  # (B, H, Lk), (B, H, 1)
    raw = torch.einsum("bhk,bkhd->bhd", pv_i8.double(), v_i8.reshape(B, Lk, H, D).double())
    return (raw.float() * pscale).to(q.dtype).reshape(B, 1, HD)


def _decode_q8_cuda(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads):
    B, _, HD = q.shape
    Lk = k_i8.shape[1]
    H = num_heads
    if HD % H:
        raise ValueError(f"decode_attention_q8: width {HD} not divisible by {H} heads")
    D = HD // H
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"decode_attention_q8: q must be bfloat16 or float32 (got {q.dtype})")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise ValueError(
            f"decode_attention_q8: caches must be int8 (got {k_i8.dtype}, {v_i8.dtype})"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_q8: head dim {D} not in {HEAD_DIMS}")
    if not 0 < Lk <= Q8_MAX_KEYS:
        raise ValueError(f"decode_attention_q8: {Lk} keys (1..{Q8_MAX_KEYS})")
    if q.shape != (B, 1, HD) or k_i8.shape != (B, Lk, HD) or v_i8.shape != (B, Lk, HD):
        raise ValueError(
            f"decode_attention_q8: shapes {tuple(q.shape)} {tuple(k_i8.shape)} {tuple(v_i8.shape)}"
        )
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dim() != 3 or t.shape[0] != B or t.shape[1] < H or t.shape[2] != Lk:
            raise ValueError(f"decode_attention_q8: {name} shape {tuple(t.shape)} != ({B}, {H}, {Lk})")
    if mask.shape != (B, Lk):
        raise ValueError(f"decode_attention_q8: mask shape {tuple(mask.shape)} != ({B}, {Lk})")
    tensors = (k_i8, v_i8, k_scale, v_scale, mask)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention_q8: all operands must be on one CUDA device")
    for name, t in (("k", k_i8), ("v", v_i8)):
        if t.stride(2) != 1 or t.stride(0) % 16 or t.stride(1) % 16 or t.data_ptr() % 16:
            raise ValueError(
                f"decode_attention_q8: {name} must have contiguous, 16-byte aligned rows "
                f"(got strides {tuple(t.stride())})"
            )
    if q.stride(2) != 1:
        raise ValueError("decode_attention_q8: q rows must be contiguous")
    k_scale = k_scale[:, :H].to(torch.float32).contiguous()
    v_scale = v_scale[:, :H].to(torch.float32).contiguous()
    if mask.dtype != torch.bool:
        mask = mask > 0
    mask = mask.contiguous()
    o = torch.empty((B, 1, HD), dtype=q.dtype, device=q.device)
    if B == 0:
        return o
    lib = _build.library("decode_attention_q8")
    with torch.cuda.device(q.device):
        err = lib.pixparse_decode_attn_q8_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k_i8), _build.ptr(v_i8),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(mask), _build.ptr(o),
            B, H, Lk, D, q.stride(0), k_i8.stride(0), k_i8.stride(1), v_i8.stride(0),
            v_i8.stride(1), float(D ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "decode_attention_q8")
    decode_attention_q8.launches += 1
    return o


def decode_attention_q8(
    q: torch.Tensor,        # (B, 1, H*D) single-position queries, heads flat
    k_i8: torch.Tensor,     # (B, Lk, H*D) int8 key cache
    v_i8: torch.Tensor,     # (B, Lk, H*D) int8 value cache
    k_scale: torch.Tensor,  # (B, H, Lk) fp32 key scales (extra head rows ignored)
    v_scale: torch.Tensor,  # (B, H, Lk) fp32 value scales
    mask: torch.Tensor,     # (B, Lk) True/nonzero = attend
    num_heads: int,
) -> torch.Tensor:
    """Single-token decode attention over int8 caches -> ``(B, 1, H*D)`` in
    q's dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return _decode_q8_cuda(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads)
    return decode_attention_q8_plain(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads)


decode_attention_q8.launches = 0
