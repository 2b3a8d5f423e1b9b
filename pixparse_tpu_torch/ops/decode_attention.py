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
  (``csrc/decode_attention_q8.cu``: the same split over all heads,
  planned by :func:`decode_plan_q8`, one cooperative launch whose splits
  exchange each head's softmax statistics and absmax of ``p * v_scale``;
  or, where :func:`decode_q8_by_heads` says so, a block per (sample,
  head)).
  The query and the rows ``p * v_scale`` are quantized per head inside,
  and both products are exact int32 sums. The scales are kept ``(B, H,
  Lk)``: the JAX package pads the head axis to a multiple of 8 for the
  TPU's sublanes, a layout the card does not need.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper's ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pixparse_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
Q8_MAX_KEYS = 32768
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


def _split_softmax_rows(s, mask, split_keys: int):
    """:func:`_masked_softmax_rows` as the int8 kernel takes it: each split
    of ``split_keys`` keys gives each head's (max, sum of exp) over its keys
    up to its last valid one (a split with no valid key gives sum 0); the
    pairs merge into the row's max and sum; p = exp(s - max) / sum."""
    B, H, Lk = s.shape
    n = -(-Lk // split_keys)
    pad = n * split_keys - Lk
    valid = F.pad(mask > 0, (0, pad)).reshape(B, 1, n, split_keys)
    s = torch.where(mask[:, None, :] > 0, s, NEG_INF)
    sp = F.pad(s, (0, pad), value=NEG_INF).reshape(B, H, n, split_keys)
    m_s = sp.amax(dim=-1, keepdim=True)
    l_s = torch.where(valid.any(dim=-1, keepdim=True), torch.exp(sp - m_s).sum(-1, keepdim=True), 0.0)
    m = m_s.amax(dim=2, keepdim=True)
    l = (l_s * torch.exp(m_s - m)).sum(dim=2)  # (B, H, 1)
    m = m[..., 0]
    dead = m <= NEG_INF * 0.5
    p = torch.exp(s - m)
    return torch.where(dead, 0.0, p / torch.where(l == 0.0, 1.0, l))


def decode_attention_q8_plain(q, k_i8, v_i8, k_scale, v_scale, mask, num_heads: int,
                              split_keys: Optional[int] = None):
    """Plain PyTorch version of the int8 kernel (the TPU kernel's math): q
    quantized per head; ``q_i8 . k_i8`` summed exactly, then scaled by
    ``qscale * (k_scale * Dh^-0.5)``; the masked softmax; ``p * v_scale``
    quantized per head over the whole row; ``pv_i8 . v_i8`` summed exactly,
    then scaled. The integer sums run in float64, exact for them (the card
    has no integer einsum), like the kernel's int32. With ``split_keys`` the
    softmax's max and sum are merged from splits of that many keys, as the
    kernel merges them (:func:`decode_plan_q8`); ``None`` takes them over
    the whole row, as the TPU kernel does."""
    B, _, HD = q.shape
    Lk = k_i8.shape[1]
    H = num_heads
    D = HD // H
    q_i8, qscale = quantize_int8_rows(q.float().reshape(B, H, D), -1)  # (B, H, D), (B, H, 1)
    raw = torch.einsum("bhd,bkhd->bhk", q_i8.double(), k_i8.reshape(B, Lk, H, D).double())
    s = (raw.float() * qscale) * (k_scale[:, :H].float() * D ** -0.5)
    if split_keys is None:
        p = _masked_softmax_rows(s, mask)
    else:
        p = _split_softmax_rows(s, mask, split_keys)
    pv = p * v_scale[:, :H].float()
    pv_i8, pscale = quantize_int8_rows(pv, -1)  # (B, H, Lk), (B, H, 1)
    raw = torch.einsum("bhk,bkhd->bhd", pv_i8.double(), v_i8.reshape(B, Lk, H, D).double())
    return (raw.float() * pscale).to(q.dtype).reshape(B, 1, HD)


Q8_THREADS = 256
Q8_TILE_BYTES = 16384  # one stage of the kernel's ring
Q8_SMEM_BYTES = 110 * 1024  # every launch: barriers, ring, then the split's region
Q8_REGION_BYTES = Q8_SMEM_BYTES - 1024 - 4 * Q8_TILE_BYTES
Q8_MAX_SPLITS = 256
Q8_MAX_ROW_BYTES = 4096  # H*D: one thread owns 16 bytes of a row
Q8_HEADS_MAX_KEYS = 2048


def decode_q8_by_heads(B: int, Lk: int, H: int, sm_count: int) -> bool:
    """Whether the int8 kernel takes a block per (sample, head), with no
    meeting between blocks, rather than the key splits of
    :func:`decode_plan_q8`: when those ``B * H`` blocks fill the card and the
    rows are short (``Lk <= Q8_HEADS_MAX_KEYS``). There the splits' two
    meetings cost more than they save (cruller_base's cross cache; the
    splits win at donut_base's 4864 keys: ``PERF.md`` §6)."""
    return B * H >= sm_count and Lk <= Q8_HEADS_MAX_KEYS


@functools.lru_cache(maxsize=256)
def decode_plan_q8(B: int, Lk: int, H: int, D: int, sm_count: int,
                   blocks_per_sm: int) -> Tuple[int, int, int, int]:
    """The int8 kernel's work split: ``(kt, split_keys, n_split, slots)``.
    A block owns one (sample, split) of ``split_keys`` keys over all heads
    and streams it in tiles of ``kt`` keys (each of the 256 threads owns 16
    bytes of a row and 4 keys of a tile: ``kt = 4 * (256 // (H*D / 16))``,
    at most 16 KB). The split's scores, scales, pv_i8 and mask bytes (13 H + 1
    bytes a key) fit the kernel's shared-memory region. The splits cover
    ``Lk``, at most ``resident // B`` of them (``resident = sm_count *
    blocks_per_sm``: about two blocks per SM); ``slots`` samples run at once
    (each block walks samples ``y, y + slots, ...``), balanced over the
    rounds, so the grid ``n_split * slots`` is always resident: the
    kernel's splits wait for each other. Raises ``ValueError`` where one
    sample's splits cannot all be resident."""
    HD = H * D
    if HD % 16 or HD > Q8_MAX_ROW_BYTES:
        raise ValueError(f"decode_attention_q8: rows of {HD} bytes (at most {Q8_MAX_ROW_BYTES})")
    kt = 4 * (Q8_THREADS // (HD // 16))
    resident = sm_count * blocks_per_sm
    max_split = Q8_REGION_BYTES // (13 * H + 1) // kt * kt
    want = max(1, resident // max(B, 1))  # splits a sample, B * want <= resident
    split = -(-max(Lk, 1) // want)
    split = min(-(-split // kt) * kt, max_split)
    n_split = -(-max(Lk, 1) // split) if split else 0
    if not split or n_split > min(resident, Q8_MAX_SPLITS):
        raise ValueError(
            f"decode_attention_q8: {H} heads x {Lk} keys need more splits than one "
            f"resident wave of {resident} blocks holds"
        )
    rounds = -(-max(B, 1) // (resident // n_split))
    return kt, split, n_split, -(-max(B, 1) // rounds)


_Q8_STATS: Dict[Tuple[int, int], torch.Tensor] = {}


def _q8_stats(device: torch.device, stream, n: int) -> torch.Tensor:
    """The int8 kernel's statistics slots: all bits set (0xffffffff marks a
    slot no split has published to), and each launch leaves them so. One
    buffer per (device, stream), as the split counters."""
    key = (device.index, stream.cuda_stream)
    buf = _Q8_STATS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.full((max(n, 4096),), -1, dtype=torch.int32, device=device)
        _Q8_STATS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _q8_blocks_per_sm(device_index: int, dtype_code: int, D: int) -> int:
    lib = _build.library("decode_attention_q8")
    with torch.cuda.device(device_index):
        n = lib.pixparse_decode_attn_q8_blocks_per_sm(dtype_code, D)
    if n <= 0:
        raise RuntimeError("decode_attention_q8: occupancy query failed")
    return n


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
    if HD > Q8_MAX_ROW_BYTES:
        raise ValueError(
            f"decode_attention_q8: rows of {HD} bytes (H*D); the kernel takes at most "
            f"{Q8_MAX_ROW_BYTES}"
        )
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
        # a key tile is one contiguous run of whole rows (a 1-D bulk copy)
        if t.stride(2) != 1 or (Lk > 1 and t.stride(1) != HD) or t.stride(0) % 16 or t.data_ptr() % 16:
            raise ValueError(
                f"decode_attention_q8: {name} must be stored (B, Lk, H*D) with contiguous rows "
                f"of H*D bytes, 16-byte aligned (got strides {tuple(t.stride())})"
            )
    if q.stride(2) != 1:
        raise ValueError("decode_attention_q8: q rows must be contiguous")
    k_scale, v_scale = k_scale.float(), v_scale.float()  # no copy when fp32 already
    if k_scale.stride() != v_scale.stride() or k_scale.stride(2) != 1:
        k_scale, v_scale = k_scale[:, :H].contiguous(), v_scale[:, :H].contiguous()
    if mask.dtype != torch.bool:
        mask = mask > 0
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    o = torch.empty((B, 1, HD), dtype=q.dtype, device=q.device)
    if B == 0:
        return o
    dev = q.device.index or 0
    code = _DTYPE_CODES[q.dtype]
    by_heads = decode_q8_by_heads(B, Lk, H, _sm_count(dev))
    kt = split = n_split = slots = 0
    if not by_heads:
        kt, split, n_split, slots = decode_plan_q8(
            B, Lk, H, D, _sm_count(dev), _q8_blocks_per_sm(dev, code, D))
    s_bs, s_hs = k_scale.stride(0), k_scale.stride(1)
    bulk = int(
        k_scale.data_ptr() % 16 == 0 and v_scale.data_ptr() % 16 == 0
        and s_bs % 4 == 0 and s_hs % 4 == 0 and Lk % 4 == 0
    )
    lib = _build.library("decode_attention_q8")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        work = (ctypes.c_void_p(None),) * 3  # the per-head kernel keeps all in one block
        if not by_heads:
            part = torch.empty(B * n_split * HD, dtype=torch.int32, device=q.device)
            work = (_build.ptr(part), _build.ptr(_q8_stats(q.device, stream, B * n_split * 3 * H)),
                    _build.ptr(_split_counters(q.device, stream, B)))
        err = lib.pixparse_decode_attn_q8_fwd(
            code, _build.ptr(q), _build.ptr(k_i8), _build.ptr(v_i8),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(mask), _build.ptr(o), *work,
            B, H, Lk, D, q.stride(0), k_i8.stride(0), v_i8.stride(0), s_bs, s_hs,
            mask.stride(0), bulk, kt, split, n_split, slots, int(by_heads), float(D ** -0.5),
            ctypes.c_void_p(stream.cuda_stream),
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
