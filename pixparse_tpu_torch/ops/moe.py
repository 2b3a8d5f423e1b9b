"""Token routing and the routed experts of a mixture-of-experts layer
(``models/moonlight.py``, DeepSeek-V3's expert layer).

- :func:`route`: the router in fp32, ``s = sigmoid(h W_r^T)``; the top-k
  experts by ``s + b`` (``b`` the correction bias, which only chooses); the
  weights ``s`` at the chosen experts, divided by their sum when asked, times
  the routed scaling factor.
- :func:`sort_by_expert`: the (token, slot) pairs sorted by expert on the
  device, and the per-expert row offsets, which stay on the device.
- :func:`moe_expert_mm` and :func:`moe_expert_wgrad`: the grouped products
  of all experts in one launch each (``csrc/moe_expert_mm.cu``); beside
  them their plain versions (a loop over experts), which a CPU tensor takes.
- :func:`routed_experts`: dispatch, the experts' SwiGLU FFN through the
  grouped products (forward ``[gate|up]`` and ``down``; backward ``dX``,
  ``dH`` and both weight gradients) and the weighted combine back onto the
  tokens, each an autograd function.

No host read anywhere on this path: the grid of a grouped product is sized
from the row count, which the host knows (tokens x k), and each block finds
its expert from the device offsets.

Tracing (``framework/profiling.py``): spans ``moe.route`` (router, top-k,
sort, offsets, dispatch), ``moe.experts`` (the grouped products) and
``moe.combine``; the counter ``moe.routed_rows`` (tokens x k); and, while
spans are collected, the device tally ``moe.expert_rows.<layer>`` of rows an
expert, read once after the collected steps. :func:`record_routes` hands a
caller each routing call's chosen experts and biased scores.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from pixparse_tpu_torch.framework.profiling import count, span, tally
from pixparse_tpu_torch.ops import _build

MOE_TILE_ROWS = 128  # csrc/moe_expert_mm.cu kBM (= kBN)
MOE_TILE_K = 64  # ... kBK
MOE_MAX_EXPERTS = 256  # ... kMaxExperts


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    experts: torch.Tensor  # (T, k) chosen experts
    weights: torch.Tensor  # (T, k) fp32 combine weights
    scores: torch.Tensor  # (T, E) fp32 s + b, what the choice was made on


def route(h: torch.Tensor, gate_weight: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float, norm_topk: bool) -> Routing:
    """DeepSeek-V3's ``noaux_tc`` gate with one expert group (``n_group`` 1,
    so the group step chooses nothing): ``h (T, D)`` -> the top ``top_k``
    experts of ``sigmoid(h W_r^T) + bias`` and their weights. Computed in
    fp32 whatever ``h``'s dtype; the gradient reaches ``gate_weight``
    through the weights."""
    s = torch.sigmoid(F.linear(h.float(), gate_weight.float()))
    biased = s + bias.float()
    experts = torch.topk(biased.detach(), top_k, dim=-1).indices
    w = s.gather(1, experts)
    if norm_topk and top_k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return Routing(experts, w * scaling, biased.detach())


class Sorted(NamedTuple):
    order: torch.Tensor  # (R,) flat (token, slot) index of sorted row r
    inverse: torch.Tensor  # (R,) sorted row of flat slot i
    offsets: torch.Tensor  # (E + 1,) int32: the rows of expert e are [o_e, o_{e+1})


def sort_by_expert(experts: torch.Tensor, num_experts: int) -> Sorted:
    """The ``(T, k)`` choices' flat slots sorted by expert (stable: tokens
    in order within an expert), on the device, with no host read."""
    flat = experts.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.arange(num_experts + 1, device=flat.device, dtype=sorted_e.dtype)
    offsets = torch.searchsorted(sorted_e, bounds).to(torch.int32)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return Sorted(order, inverse, offsets)


_routes: Optional[List[Routing]] = None  # the open record_routes() list


@contextlib.contextmanager
def record_routes():
    """Yield a list that gets each routing call's :class:`Routing` (chosen
    experts, weights and biased scores, detached) in call order while the
    block runs; off again at exit. Nothing is recorded otherwise."""
    global _routes
    saved, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = saved


# ---------------------------------------------------------------------------
# grouped products: kernels and plain versions
# ---------------------------------------------------------------------------

def _expert_rows(offsets: torch.Tensor):
    bounds = offsets.tolist()  # CPU tensors only: the plain versions
    return [slice(bounds[e], bounds[e + 1]) for e in range(len(bounds) - 1)]


def moe_expert_mm_plain(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                        b_kn: bool = False) -> torch.Tensor:
    """Plain version of :func:`moe_expert_mm`: for each expert its rows of
    ``a`` times ``b[e]`` (transposed unless ``b_kn``), fp32 accumulation,
    rounded once to ``a``'s dtype. Rows outside every expert are zero."""
    c = a.new_zeros((a.shape[0], b.shape[2] if b_kn else b.shape[1]))
    for e, rows in enumerate(_expert_rows(offsets)):
        w = b[e].float() if b_kn else b[e].float().t()
        c[rows] = (a[rows].float() @ w).to(a.dtype)
    return c


def moe_expert_wgrad_plain(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`moe_expert_wgrad`: ``(E, M, N)``, expert e's
    rows of ``a`` transposed times its rows of ``b`` (zeros for an expert
    without rows), fp32 accumulation, rounded once."""
    rows = _expert_rows(offsets)
    c = a.new_zeros((len(rows), a.shape[1], b.shape[1]))
    for e, r in enumerate(rows):
        c[e] = (a[r].float().t() @ b[r].float()).to(a.dtype)
    return c


def _check_grouped(name: str, offsets: torch.Tensor, *tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: the kernel takes bfloat16 operands, got "
                         f"{[t.dtype for t in tensors]}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError(f"{name}: offsets are a 1-D int32 tensor, got {offsets.dtype}")
    device = tensors[0].device
    if any(t.device != device for t in (*tensors, offsets)):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def moe_expert_mm(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                  b_kn: bool = False) -> torch.Tensor:
    """``c[o_e:o_{e+1}] = a[o_e:o_{e+1}] b[e]^T`` (``b (E, N, K)``), or
    ``... b[e]`` with ``b_kn`` (``b (E, K, N)``), for every expert in one
    launch: ``a (R, K)`` bf16 rows sorted by expert, ``offsets (E + 1,)``
    int32 on the device with ``o_0 = 0`` and ``o_E = R``. The kernel for
    CUDA tensors (N a multiple of 128, K of 64), the plain version for CPU
    tensors. ``launches`` counts calls that launched."""
    if not a.is_cuda:
        return moe_expert_mm_plain(a, b, offsets, b_kn)
    a, b = a.contiguous(), b.contiguous()
    _check_grouped("moe_expert_mm", offsets, a, b)
    R, K = a.shape
    E = b.shape[0]
    N = b.shape[2] if b_kn else b.shape[1]
    if b.shape != ((E, K, N) if b_kn else (E, N, K)) or offsets.shape != (E + 1,):
        raise ValueError(f"moe_expert_mm: a {tuple(a.shape)} b {tuple(b.shape)} "
                         f"offsets {tuple(offsets.shape)} (b_kn={b_kn})")
    if N % MOE_TILE_ROWS or K % MOE_TILE_K or E > MOE_MAX_EXPERTS:
        raise ValueError(f"moe_expert_mm: N={N} must be a multiple of {MOE_TILE_ROWS}, "
                         f"K={K} of {MOE_TILE_K}, E={E} at most {MOE_MAX_EXPERTS}")
    c = torch.empty((R, N), dtype=a.dtype, device=a.device)
    row_tiles = -(-R // MOE_TILE_ROWS) + E if R else 0
    lib = _build.library("moe_expert_mm")
    with torch.cuda.device(a.device):
        err = lib.pixparse_moe_expert_mm(
            _build.ptr(a), _build.ptr(b), _build.ptr(c), _build.ptr(offsets.contiguous()),
            E, N, K, int(b_kn), row_tiles, _build.stream_ptr(a.device))
    _build.check(err, "moe_expert_mm")
    moe_expert_mm.launches += 1
    return c


moe_expert_mm.launches = 0


def moe_expert_wgrad(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``c[e] = a[o_e:o_{e+1}]^T b[o_e:o_{e+1}]``, ``(E, M, N)`` for ``a (R,
    M)`` and ``b (R, N)`` bf16 rows sorted by expert, every expert in one
    launch (zeros for an expert without rows). The kernel for CUDA tensors
    (M and N multiples of 128), the plain version for CPU tensors.
    ``launches`` counts calls that launched."""
    if not a.is_cuda:
        return moe_expert_wgrad_plain(a, b, offsets)
    a, b = a.contiguous(), b.contiguous()
    _check_grouped("moe_expert_wgrad", offsets, a, b)
    (R, M), N = a.shape, b.shape[1]
    E = offsets.shape[0] - 1
    if b.shape[0] != R or M % MOE_TILE_ROWS or N % MOE_TILE_ROWS or E < 1:
        raise ValueError(f"moe_expert_wgrad: a {tuple(a.shape)} b {tuple(b.shape)}: M and N "
                         f"must be multiples of {MOE_TILE_ROWS}, offsets (E + 1,)")
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    lib = _build.library("moe_expert_mm")
    with torch.cuda.device(a.device):
        err = lib.pixparse_moe_expert_wgrad(
            _build.ptr(a), _build.ptr(b), _build.ptr(c), _build.ptr(offsets.contiguous()),
            E, M, N, _build.stream_ptr(a.device))
    _build.check(err, "moe_expert_wgrad")
    moe_expert_wgrad.launches += 1
    return c


moe_expert_wgrad.launches = 0


# ---------------------------------------------------------------------------
# SwiGLU, dispatch, experts, combine: autograd functions
# ---------------------------------------------------------------------------

def _swiglu_fwd(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * u


def _swiglu_bwd(g, u, dh):
    """``(dg, du)`` in the inputs' dtype: ATen's fused ``silu_backward`` (fp32
    inside) for ``dg``, so the backward makes four passes over the rows."""
    return torch.ops.aten.silu_backward(dh * u, g), dh * F.silu(g)


class _SwiGLU(torch.autograd.Function):
    """``silu(g) * u`` in the inputs' dtype (HF DeepSeek-V3's rounding);
    saves its inputs only and recomputes ``silu(g)`` in the backward."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return _swiglu_fwd(g, u)

    @staticmethod
    def backward(ctx, dh):
        return _swiglu_bwd(*ctx.saved_tensors, dh)


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The gated FFN's activation ``silu(g) * u`` (the dense layer, the
    shared and the routed experts)."""
    return _SwiGLU.apply(g, u)


class _Dispatch(torch.autograd.Function):
    """Token rows -> the sorted (token, slot) rows: ``x[order // k]``. The
    backward gathers each token's k rows back and sums them (fp32
    accumulation), with no atomics."""

    @staticmethod
    def forward(ctx, x, order, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return x.index_select(0, torch.div(order, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, dxs):
        (inverse,) = ctx.saved_tensors
        T = inverse.numel() // ctx.k
        dx = dxs.index_select(0, inverse).view(T, ctx.k, -1).sum(1)
        return dx, None, None, None


class _ExpertFFN(torch.autograd.Function):
    """The routed experts' SwiGLU FFN on rows sorted by expert:
    ``y = swiglu(x W1_e^T) W2_e^T`` with ``W1 (E, 2F, D)`` = ``[gate; up]``
    and ``W2 (E, D, F)``. Forward: two grouped products; backward: ``dH``,
    ``dW2``, ``dX`` and ``dW1``, four more. Saves ``x`` and the first
    product; the activation is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, w1, w2, offsets):
        y1 = moe_expert_mm(x, w1, offsets)
        g, u = y1.chunk(2, dim=-1)
        h = _swiglu_fwd(g, u)
        ctx.save_for_backward(x, y1, w1, w2, offsets)
        return moe_expert_mm(h, w2, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, y1, w1, w2, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        g, u = y1.chunk(2, dim=-1)
        h = _swiglu_fwd(g, u)
        dh = moe_expert_mm(dy, w2, offsets, b_kn=True)
        dw2 = moe_expert_wgrad(dy, h, offsets)
        dg, du = _swiglu_bwd(g, u, dh)
        dy1 = torch.cat([dg, du], dim=-1)
        dx = moe_expert_mm(dy1, w1, offsets, b_kn=True)
        dw1 = moe_expert_wgrad(dy1, x, offsets)
        return dx, dw1, dw2, None


class _Combine(torch.autograd.Function):
    """Sorted expert rows -> tokens: ``out[t] = sum_j w[t, j] y[row(t, j)]``
    in fp32, rounded once to ``y``'s dtype."""

    @staticmethod
    def forward(ctx, y, w, order, inverse):
        T, k = w.shape
        yu = y.index_select(0, inverse).view(T, k, -1)
        out = yu[:, 0].float() * w[:, :1]
        for j in range(1, k):
            out += yu[:, j].float() * w[:, j:j + 1]
        ctx.save_for_backward(y, w, order, inverse)
        return out.to(y.dtype)

    @staticmethod
    def backward(ctx, dout):
        y, w, order, inverse = ctx.saved_tensors
        T, k = w.shape
        yu = y.index_select(0, inverse).view(T, k, -1)
        df = dout.float()
        dw = torch.stack([(df * yu[:, j].float()).sum(-1) for j in range(k)], dim=1)
        dyu = (df[:, None, :] * w[:, :, None]).to(y.dtype).view(T * k, -1)
        return dyu.index_select(0, order), dw, None, None


def routed_experts(h: torch.Tensor, gate_weight: torch.Tensor, bias: torch.Tensor,
                   w1: torch.Tensor, w2: torch.Tensor, top_k: int, scaling: float,
                   norm_topk: bool, layer: int = 0) -> torch.Tensor:
    """The routed half of an expert layer for tokens ``h (T, D)`` in the
    compute dtype: route, sort, dispatch, the experts (``w1``, ``w2`` in the
    compute dtype, ``(E, 2F, D)`` and ``(E, D, F)``), combine. ``layer``
    names the layer's tally."""
    T = h.shape[0]
    E = w1.shape[0]
    with span("moe.route"):
        r = route(h, gate_weight, bias, top_k, scaling, norm_topk)
        srt = sort_by_expert(r.experts, E)
        count("moe.routed_rows", T * top_k)
        tally(f"moe.expert_rows.{layer}", lambda: srt.offsets.diff())
        if _routes is not None:
            _routes.append(r._replace(weights=r.weights.detach()))
        xs = _Dispatch.apply(h, srt.order, srt.inverse, top_k)
    with span("moe.experts"):
        ys = _ExpertFFN.apply(xs, w1, w2, srt.offsets)
    with span("moe.combine"):
        return _Combine.apply(ys, r.weights, srt.order, srt.inverse)
