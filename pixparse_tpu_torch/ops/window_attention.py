"""Swin window attention, forward and backward: CUDA kernels for Hopper and
their plain versions.

Counterpart of :func:`pixparse_tpu.ops.window_attention.window_attention`.
Per window and head::

    softmax(q k^T * Dh^-0.5 + bias[h] + mask[w % nW]) v

with q/k/v ``(nB, ww, C)``, ``C = H * Dh``, heads flat in the channels;
``bias`` ``(H, ww, ww)`` and ``mask`` ``(nW, ww, ww)`` fp32. Windows are
ordered ``b * nW + w`` (``models/swin.py::_window_partition``), so the mask
repeats with period ``nW``. The scale multiplies the fp32 product before
the bias and then the mask are added, the softmax runs in fp32 and p is
rounded to the input dtype before ``p v``. (The bf16 kernels add bias +
mask, summed once per window position: at most one fp32 rounding of a
logit apart, none for Swin's 0 / -1e9 masks.)

Backward (both versions), from q, k, v, do and the forward's bias and mask
(no lse is saved, as in JAX): s and the softmax are recomputed in fp32,
``dv = p^T do`` with p rounded to the input dtype, ``ds = p * (dp - sum_j p
dp)`` in fp32 from the unrounded p, ``dq = ds k`` and ``dk = ds^T q`` with
``ds * Dh^-0.5`` rounded to the input dtype, and ``dbias[h]`` the fp32 sum of
ds over every window. The mask gets no gradient; the bias table's gradient
flows through the gather outside, as in JAX.

:func:`window_attention` is a :class:`torch.autograd.Function` over the two.
Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels (``csrc/window_attention.cu``, ``csrc/window_attention_bwd.cu``) or
raises. ``window_attention.launches`` and ``window_attention_bwd.launches``
count wrapper calls that launched (the backward's call launches the
backward kernel and the dbias reduction).

Both kernels walk the work :func:`window_plan` lays out: one wave of
persistent blocks, each a static run of (window position, image) items of
one head, the runs of a head balanced within one item.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

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


class WindowPlan(NamedTuple):
    """The kernels' grid: ``runs`` runs of each head's ``items`` (window
    position, image) items, one block per (head, run), ``grid = H * runs``.
    The backward writes one dbias partial per block."""

    runs: int
    grid: int
    items: int


def window_plan(nB: int, period: int, H: int, N: int, D: int, n_sms: int,
                blocks_per_sm: int) -> WindowPlan:
    """Work of the window kernels for ``nB`` windows (mask period
    ``period``, 1 without a mask), ``H`` heads of ``D`` channels and ``N``
    tokens, on ``n_sms`` SMs that each hold ``blocks_per_sm`` blocks (the
    kernel's own occupancy, from its registers and shared memory).

    Each head's ``period * (nB // period)`` items, window position major,
    are cut into the same number of runs, as many as one wave of blocks
    allows (each head at least one, at most one item a run). Block ``r * H
    + h`` takes run ``r`` of head ``h``: items ``r * n // runs`` to ``(r + 1)
    * n // runs``, so the runs differ by at most one item, a block keeps
    bias[h] for its whole run, and the heads' blocks of one run index cover
    the same window positions at the same time."""
    if nB <= 0 or period <= 0 or nB % period or H <= 0:
        raise ValueError(f"window_plan: {nB} windows, period {period}, {H} heads")
    if not 0 < N <= MAX_WINDOW_TOKENS or D not in HEAD_DIMS:
        raise ValueError(f"window_plan: {N} tokens, head dim {D}")
    if n_sms <= 0 or blocks_per_sm <= 0:
        raise ValueError(f"window_plan: {n_sms} SMs x {blocks_per_sm} blocks")
    items = nB  # period * (nB // period)
    runs = max(1, min(items, n_sms * blocks_per_sm // H))
    return WindowPlan(runs, H * runs, items)


def bwd_partials_shape(plan: WindowPlan, H: int, N: int) -> Tuple[int, int, int, int]:
    """The backward's dbias scratch: one ``(N, N)`` fp32 partial per block."""
    return (H, plan.runs, N, N)


def table_layout(N: int) -> Tuple[int, int]:
    """``(ldb, nn)`` of the kernels' bias and mask tables: N rows of ``ldb``
    floats (N rounded up to even: pairs of logits are read as one float2),
    one table every ``nn`` floats (a multiple of 4: one 16-byte aligned bulk
    copy)."""
    ldb = N + (N & 1)
    return ldb, -(-N * ldb // 4) * 4


def _tables(t: torch.Tensor, N: int) -> torch.Tensor:
    """``(n, N, N)`` -> ``(n, nn)`` fp32 tables in :func:`table_layout`'s
    layout; a view of the input for even N (no copy)."""
    ldb, nn = table_layout(N)
    t = t.to(torch.float32).contiguous()
    if ldb == N and nn == N * N:
        return t.reshape(t.shape[0], nn)
    out = t.new_zeros((t.shape[0], nn))
    out[:, : N * ldb].view(t.shape[0], N, ldb)[:, :, :N] = t
    return out


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _config_cached(kind: str, dtype_code: int, N: int, D: int, has_mask: bool, index: int) -> dict:
    import ctypes

    lib = _build.library("window_attention" if kind == "fwd" else "window_attention_bwd")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        err = getattr(lib, f"pixparse_window_attn_{kind}_config")(
            dtype_code, N, D, int(has_mask), ctypes.cast(out, ctypes.c_void_p))
    _build.check(err, f"window_attention {kind} config")
    keys = ("blocks_per_sm", "smem_bytes", "stages", "mask_slots", "bias_in_smem", "threads")
    return dict(zip(keys, list(out)))


def window_config(kind: str, dtype: torch.dtype, N: int, D: int, has_mask: bool, device) -> dict:
    """What one launch of the ``kind`` (``"fwd"`` or ``"bwd"``) kernel uses
    on ``device``: blocks per SM, dynamic shared memory, ring stages, mask
    slots, whether bias[h] sits in shared memory, threads per block."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return _config_cached(kind, _DTYPE_CODES[dtype], N, D, bool(has_mask), index)


@functools.lru_cache(maxsize=256)
def _launch_plan(kind: str, dtype: torch.dtype, nB: int, period: int, H: int, N: int, D: int,
                 has_mask: bool, index: int) -> WindowPlan:
    cfg = _config_cached(kind, _DTYPE_CODES[dtype], N, D, has_mask, index)
    return window_plan(nB, period, H, N, D, _n_sms(index), cfg["blocks_per_sm"])


def _window_cuda(q, k, v, bias, mask):
    nB, N, C = q.shape
    H = bias.shape[0]
    Dh = C // H
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
    o = torch.empty((nB, N, C), dtype=q.dtype, device=q.device)
    if nB == 0:
        return o
    period = 1 if mask is None else mask.shape[0]
    ldb, nn = table_layout(N)
    bias_t = _tables(bias, N)
    mask_t = None if mask is None else _tables(mask, N)
    plan = _launch_plan("fwd", q.dtype, nB, period, H, N, Dh, mask is not None, q.device.index)
    lib = _build.library("window_attention")
    with torch.cuda.device(q.device):
        err = lib.pixparse_window_attn_fwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(bias_t), None if mask_t is None else _build.ptr(mask_t), _build.ptr(o),
            nB, period, N, H, Dh, nn, ldb, plan.runs,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(Dh ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "window_attention")
    window_attention.launches += 1
    return o


def window_attention_bwd_plain(q, k, v, do, bias, mask=None):
    """Plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` in q's
    dtype, ``(nB, ww, C)``, and ``dbias (H, ww, ww)`` fp32, with the kernel's
    rounding points."""
    _check_args(q, bias, mask)
    nB, N, C = q.shape
    H = bias.shape[0]
    Dh = C // H
    scale = Dh ** -0.5
    heads = lambda t: t.reshape(nB, N, H, Dh).float()
    qf, kf, vf, dof = heads(q), heads(k), heads(v), heads(do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(nB // nW, nW, H, N, N) + mask.float()[None, :, None]).reshape(nB, H, N, N)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dsb = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf)
    out = lambda t: t.reshape(nB, N, C).to(q.dtype)
    return out(dq), out(dk), out(dv), dbias


def _window_bwd_cuda(q, k, v, do, bias, mask):
    nB, N, C = q.shape
    H = bias.shape[0]
    Dh = C // H
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == do.dtype == q.dtype):
        raise ValueError(
            f"window_attention_bwd: CUDA kernel takes bfloat16 or float32 q/k/v/do of one "
            f"dtype (got {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype})"
        )
    if Dh not in HEAD_DIMS:
        raise ValueError(f"window_attention_bwd: head dim {Dh} not in {HEAD_DIMS}")
    if not 0 < N <= MAX_WINDOW_TOKENS:
        raise ValueError(f"window_attention_bwd: {N} tokens per window (1..{MAX_WINDOW_TOKENS})")
    if any(t.shape != q.shape for t in (k, v, do)) or bias.shape != (H, N, N):
        raise ValueError(
            f"window_attention_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do {tuple(do.shape)} bias {tuple(bias.shape)}"
        )
    if mask is not None and mask.shape[1:] != (N, N):
        raise ValueError(f"window_attention_bwd: mask shape {tuple(mask.shape)}")
    tensors = (q, k, v, do, bias) + (() if mask is None else (mask,))
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("window_attention_bwd: all operands must be on one CUDA device")
    if not _rows_ok(do):  # autograd may hand the cotangent over in another layout
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_ok(t):
            raise ValueError(
                f"window_attention_bwd: {name} must have contiguous, 16-byte aligned "
                f"rows (got strides {tuple(t.stride())})"
            )
    dq, dk, dv = (torch.empty((nB, N, C), dtype=q.dtype, device=q.device) for _ in range(3))
    dbias = torch.empty((H, N, N), dtype=torch.float32, device=q.device)
    if nB == 0:
        return dq, dk, dv, dbias.zero_()
    period = 1 if mask is None else mask.shape[0]
    ldb, nn = table_layout(N)
    bias_t = _tables(bias, N)
    mask_t = None if mask is None else _tables(mask, N)
    plan = _launch_plan("bwd", q.dtype, nB, period, H, N, Dh, mask is not None, q.device.index)
    partial = torch.empty(bwd_partials_shape(plan, H, N), dtype=torch.float32, device=q.device)
    lib = _build.library("window_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.pixparse_window_attn_bwd(
            _DTYPE_CODES[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
            _build.ptr(bias_t), None if mask_t is None else _build.ptr(mask_t),
            _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), _build.ptr(partial), _build.ptr(dbias),
            nB, period, N, H, Dh, nn, ldb, plan.runs,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1), float(Dh ** -0.5), _build.stream_ptr(q.device),
        )
    _build.check(err, "window_attention_bwd")
    window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


def window_attention_bwd(q, k, v, do, bias, mask=None):
    """``(dq, dk, dv, dbias)``: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors. ``launches`` counts calls that launched."""
    _check_args(q, bias, mask)
    if q.is_cuda:
        return _window_bwd_cuda(q, k, v, do, bias, mask)
    return window_attention_bwd_plain(q, k, v, do, bias, mask)


window_attention_bwd.launches = 0


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias, mask)
        if q.is_cuda:
            return _window_cuda(q, k, v, bias, mask)
        return window_attention_plain(q, k, v, bias, mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, do.to(q.dtype), bias, mask)
        return dq, dk, dv, dbias.to(bias.dtype), None


def window_attention(
    q: torch.Tensor,  # (nB, ww, C), nB = batch * windows per image, C = H * Dh
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, ww, ww) relative-position bias (differentiable)
    mask: Optional[torch.Tensor] = None,  # (nW, ww, ww) shift mask (constant)
) -> torch.Tensor:
    """Fused per-window attention -> ``(nB, ww, C)``: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors. Differentiable in q, k,
    v and bias."""
    _check_args(q, bias, mask)
    return _WindowAttention.apply(q, k, v, bias, mask)


window_attention.launches = 0
