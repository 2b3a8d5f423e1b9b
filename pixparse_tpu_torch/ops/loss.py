"""Loss functions (counterpart of :mod:`pixparse_tpu.ops.loss`).

Mean cross entropy over the targets that are not ``IGNORE_ID``, computed in
fp32 whatever the compute dtype. Three implementations of the tied-head CE
from the decoder's hidden states:

- :func:`cross_entropy_loss`: plain, over materialized logits.
- :func:`chunked_cross_entropy_from_hidden`: a loop over 128-token chunks
  under ``torch.utils.checkpoint``; the full ``(B, L, V)`` logits never
  exist at once.
- :func:`fused_cross_entropy_from_hidden`: a :class:`torch.autograd.Function`
  over the CUDA kernels of ``csrc/fused_ce.cu``: the (T, V) logits never
  reach device memory. The forward is one product over the whole
  vocabulary whose epilogue keeps, per token and 256-entry vocabulary tile,
  a (max, sum-exp) pair (:func:`_ce_fwd_plan`) and the target's logit; a
  second kernel merges the pairs into the lse. The backward
  walks the vocabulary in chunks (:func:`_ce_bwd_plan`): per chunk one
  product builds ``g = (softmax - onehot) * coef``, rounded to the hidden
  dtype, into a (T, chunk) workspace, and two more take ``dE = g^T h`` and
  ``dh += g E`` from it.

Under tensor parallelism the table's rows are split over the ``model``
axis (``ceil(V / model)`` a rank, the last fewer): each rank runs the same
kernels on its rows with targets shifted to them (``vocab_shard`` of
:func:`fused_cross_entropy_from_hidden`); the ranks' ``(lse, tgt)``
combine by a max and two sums, ``dh`` is summed over the ranks and ``dE``
stays each rank's own.

Beside the kernels stand :func:`fused_ce_fwd_plain` and
:func:`fused_ce_bwd_plain`, plain PyTorch with the same rounding points; a
CPU tensor takes them, a CUDA tensor launches the kernels or raises.
:func:`cross_entropy_from_hidden` is what the train tasks call: the fused
path on either device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.parallel.tensor_parallel import all_reduce_model

IGNORE_ID = -100
DEAD_LSE = -1e30
CE_BF16_WIDTHS = (64, 768, 1024)  # depths the bf16 kernels are built for
# The bf16 backward's workspace: g of one vocabulary chunk, (T, chunk) bf16,
# the chunk a multiple of the kernels' vocabulary tile (also the tile of the
# forward's partials).
CE_BWD_WORKSPACE_BYTES = 256 << 20
CE_BWD_VOCAB_TILE = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cross_entropy_loss(
    logits: torch.Tensor,  # (..., V)
    targets: torch.Tensor,  # (...), int ids with IGNORE_ID masked out
    ignore_id: int = IGNORE_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored targets. Returns ``(loss, num_valid)``."""
    logits = logits.float()
    valid = targets != ignore_id
    safe = torch.where(valid, targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - true_logit) * valid
    n_valid = valid.sum()
    return nll.sum() / n_valid.clamp_min(1), n_valid


def _chunk_nll(h, embedding, t, ignore_id):
    logits = torch.matmul(h, embedding.t()).float()  # lives only inside this chunk
    valid = t != ignore_id
    safe = torch.where(valid, t, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - true_logit) * valid).sum()


def chunked_cross_entropy_from_hidden(
    hidden: torch.Tensor,  # (B, L, D) decoder output (pre-head)
    embedding: torch.Tensor,  # (V, D) tied LM-head table
    targets: torch.Tensor,  # (B, L) int ids with IGNORE_ID masked out
    ignore_id: int = IGNORE_ID,
    chunk_size: int = 128,
    denominator: Optional[torch.Tensor] = None,
    vocab_shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-frugal tied-head CE: the logits of one sequence chunk at a time,
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    ``(B, L, V)`` logits never exist at once. ``denominator`` as
    :func:`fused_cross_entropy_from_hidden`'s; ``vocab_shard`` must be None
    (this CE takes the whole table)."""
    if vocab_shard is not None:
        raise ValueError("chunked_cross_entropy_from_hidden takes a whole table, "
                         "not a vocab shard")
    L = hidden.shape[1]
    nll_sum = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, L, chunk_size):
        h = hidden[:, lo:lo + chunk_size]
        t = targets[:, lo:lo + chunk_size]
        if torch.is_grad_enabled() and (h.requires_grad or embedding.requires_grad):
            nll_sum = nll_sum + checkpoint(
                _chunk_nll, h, embedding, t, ignore_id, use_reentrant=False
            )
        else:
            nll_sum = nll_sum + _chunk_nll(h, embedding, t, ignore_id)
    n_valid = (targets != ignore_id).sum()
    if denominator is None:
        denominator = n_valid.clamp_min(1)
    return nll_sum / denominator, n_valid


# ---------------------------------------------------------------------------
# fused tied-head CE: kernels, plain versions, autograd
# ---------------------------------------------------------------------------

def fused_ce_fwd_plain(
    h: torch.Tensor,  # (T, D)
    e: torch.Tensor,  # (V, D)
    target: torch.Tensor,  # (T,) int, -1 where ignored
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(lse (T,), tgt (T,))`` fp32,
    ``tgt`` the target's logit (0 where the target matches no column)."""
    s = torch.matmul(h.float(), e.float().t())
    lse = torch.logsumexp(s, dim=-1)
    hit = target[:, None] == torch.arange(e.shape[0], device=h.device)[None, :]
    tgt = torch.where(hit, s, 0.0).sum(-1)
    return lse, tgt


def _ce_bwd_g(h, e, target, lse, coef, v0=0):
    """g of the vocabulary rows ``e`` (those from ``v0`` on), rounded to
    ``h``'s dtype, as fp32."""
    s = torch.matmul(h.float(), e.float().t())
    p = torch.exp(s - lse.clamp_min(0.5 * DEAD_LSE)[:, None])
    onehot = target[:, None] == torch.arange(v0, v0 + e.shape[0], device=h.device)[None, :]
    return ((p - onehot.float()) * coef[:, None]).to(h.dtype).float()


def fused_ce_bwd_plain(
    h: torch.Tensor,
    e: torch.Tensor,
    target: torch.Tensor,  # (T,) int, -1 where ignored
    lse: torch.Tensor,  # (T,) fp32
    coef: torch.Tensor,  # (T,) fp32: d loss / d nll[t], 0 where ignored
    vocab_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(dh (T, D), dE (V, D))`` in
    the dtypes of ``h`` and ``e``; ``g`` is rounded to ``h``'s dtype before
    its two products, which accumulate in fp32.

    ``vocab_chunk`` follows the bf16 kernels' order instead (for tests): per
    chunk of that many vocabulary rows, g, that chunk's rows of dE, and dh
    summed in fp32 chunk by chunk, rounded once at the end."""
    if vocab_chunk is None:
        g = _ce_bwd_g(h, e, target, lse, coef)
        dh = torch.matmul(g, e.float())
        de = torch.matmul(g.t(), h.float())
        return dh.to(h.dtype), de.to(e.dtype)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    de = torch.empty_like(e)
    for v0 in range(0, e.shape[0], vocab_chunk):
        ec = e[v0:v0 + vocab_chunk]
        g = _ce_bwd_g(h, ec, target, lse, coef, v0)
        de[v0:v0 + vocab_chunk] = torch.matmul(g.t(), h.float()).to(e.dtype)
        dh += torch.matmul(g, ec.float())
    return dh.to(h.dtype), de


def _ce_bwd_plan(T: int, V: int, D: int) -> Tuple[int, List[Tuple[int, int]], int]:
    """The bf16 backward's vocabulary chunks: ``(Vc, [(v0, v1), ...],
    workspace_bytes)``. ``Vc`` is the largest multiple of the vocabulary tile
    whose (T, Vc) bf16 workspace fits ``CE_BWD_WORKSPACE_BYTES`` (at least
    one tile, at most V rounded up to a tile); the chunks cover [0, V) in
    order. ``D`` does not change the plan: every width takes the same
    chunks."""
    tile = CE_BWD_VOCAB_TILE
    fit = CE_BWD_WORKSPACE_BYTES // (2 * max(T, 1)) // tile * tile
    Vc = min(max(fit, tile), -(-V // tile) * tile)
    chunks = [(v0, min(v0 + Vc, V)) for v0 in range(0, V, Vc)]
    return Vc, chunks, 2 * T * Vc


def _ce_fwd_plan(T: int, V: int) -> Tuple[int, int]:
    """The bf16 forward's partials: ``(n_vtiles, bytes)``, one fp32 (max,
    sum-exp) pair per token and vocabulary tile (the last tile may be
    partial)."""
    n_vtiles = -(-V // CE_BWD_VOCAB_TILE)
    return n_vtiles, 8 * n_vtiles * T


def _check_ce_operands(name, h, e, target):
    T, D = h.shape
    if h.dtype not in _DTYPE_CODES or e.dtype != h.dtype:
        raise ValueError(
            f"{name}: CUDA kernels take bfloat16 or float32 hidden states and "
            f"table of one dtype (got {h.dtype}, {e.dtype})"
        )
    if e.dim() != 2 or e.shape[1] != D or target.shape != (T,):
        raise ValueError(
            f"{name}: shapes h {tuple(h.shape)} e {tuple(e.shape)} target {tuple(target.shape)}"
        )
    if h.dtype == torch.bfloat16 and D not in CE_BF16_WIDTHS:
        raise ValueError(f"{name}: bf16 kernels are built for widths {CE_BF16_WIDTHS}, got {D}")
    if h.dtype == torch.float32 and (D > 1024 or D % 4):
        raise ValueError(f"{name}: fp32 kernels take widths <= 1024 divisible by 4, got {D}")
    if not (e.is_cuda and target.is_cuda):
        raise ValueError(f"{name}: all operands must be on one CUDA device")


def fused_ce_fwd(h: torch.Tensor, e: torch.Tensor, target: torch.Tensor):
    """``(lse, tgt)`` per token: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors. ``launches`` counts calls that launched (bf16: a
    product and a merge, with (max, sum-exp) partials from the caching
    allocator for the length of the call)."""
    if not h.is_cuda:
        return fused_ce_fwd_plain(h, e, target)
    _check_ce_operands("fused_ce_fwd", h, e, target)
    h, e = h.contiguous(), e.contiguous()
    target = target.to(torch.int32).contiguous()
    T, D = h.shape
    lse = torch.empty((T,), dtype=torch.float32, device=h.device)
    tgt = torch.empty((T,), dtype=torch.float32, device=h.device)
    if T == 0:
        return lse, tgt
    V = e.shape[0]
    part = None
    if h.dtype == torch.bfloat16:
        h, e = _tma_aligned(h), _tma_aligned(e)
        n_vtiles, _ = _ce_fwd_plan(T, V)
        part = torch.empty((n_vtiles, T, 2), dtype=torch.float32, device=h.device)
    lib = _build.library("fused_ce")
    with torch.cuda.device(h.device):
        err = lib.pixparse_fused_ce_fwd(
            _DTYPE_CODES[h.dtype], _build.ptr(h), _build.ptr(e), _build.ptr(target),
            _build.ptr(lse), _build.ptr(tgt), None if part is None else _build.ptr(part),
            T, V, D, _build.stream_ptr(h.device),
        )
    _build.check(err, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return lse, tgt


fused_ce_fwd.launches = 0


def _tma_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its base is 16-byte aligned (as TMA needs), else an
    aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_ce_bwd(h, e, target, lse, coef):
    """``(dh, dE)``: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors. ``launches`` counts calls that launched (one bf16 call
    launches three products per vocabulary chunk, fp32 a dh and a dE
    kernel). bf16 takes a (T, Vc) workspace and, with more than one chunk,
    a (T, D) fp32 dh accumulator from the caching allocator for the length
    of the call."""
    if not h.is_cuda:
        return fused_ce_bwd_plain(h, e, target, lse, coef)
    _check_ce_operands("fused_ce_bwd", h, e, target)
    h, e = h.contiguous(), e.contiguous()
    target = target.to(torch.int32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    coef = coef.to(torch.float32).contiguous()
    T, D = h.shape
    V = e.shape[0]
    dh = torch.empty_like(h)
    de = torch.empty_like(e)
    if T == 0:
        return dh, de.zero_()
    ws = dh_acc = None
    Vc = 0
    if h.dtype == torch.bfloat16:
        h, e = _tma_aligned(h), _tma_aligned(e)
        Vc, chunks, _ = _ce_bwd_plan(T, V, D)
        ws = torch.empty((T, Vc), dtype=torch.bfloat16, device=h.device)
        if len(chunks) > 1:
            dh_acc = torch.empty((T, D), dtype=torch.float32, device=h.device)
    lib = _build.library("fused_ce")
    with torch.cuda.device(h.device):
        err = lib.pixparse_fused_ce_bwd(
            _DTYPE_CODES[h.dtype], _build.ptr(h), _build.ptr(e), _build.ptr(target),
            _build.ptr(lse), _build.ptr(coef), _build.ptr(dh), _build.ptr(de),
            None if ws is None else _build.ptr(ws),
            None if dh_acc is None else _build.ptr(dh_acc),
            T, V, D, Vc, _build.stream_ptr(h.device),
        )
    _build.check(err, "fused_ce_bwd")
    fused_ce_bwd.launches += 1
    return dh, de


fused_ce_bwd.launches = 0


def shard_targets(target: torch.Tensor, offset: int) -> torch.Tensor:
    """Safe targets (-1 where ignored) shifted to a vocabulary shard whose
    first row is ``offset``: ignored rows stay -1, a target outside the
    shard lands below 0 or at or past its rows, where it matches no column
    (the kernels' target logit is 0 there)."""
    return torch.where(target >= 0, target - offset, target)


def merge_vocab_shards(lse: torch.Tensor, tgt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole vocabulary's ``(lse, tgt)`` ``(T,)`` from the shards'
    ``(S, T)`` stacks, in shard order: ``lse = m + log sum_s exp(lse_s -
    m)`` with ``m`` their max (a dead shard row, lse at or below
    ``DEAD_LSE / 2``, adds nothing), ``tgt`` their sum (one shard holds
    the target)."""
    m = lse.max(dim=0).values
    contrib = torch.where(lse > 0.5 * DEAD_LSE, torch.exp(lse - m), 0.0)
    return m + torch.log(contrib.sum(dim=0)), tgt.sum(dim=0)


class _FusedCETokens(torch.autograd.Function):
    """Per-token nll ``(T,)`` fp32 from ``h (T, D)``, ``e (V, D)`` and safe
    targets (-1 where ignored; those rows give nll 0).

    ``vocab_shard``: None, or ``(TPGroup, offset)`` when ``e`` is this
    rank's rows of a table split over the ``model`` axis, from ``offset``
    on (the JAX package's vocab-parallel fused CE). The same kernels then
    run on the rank's rows with shifted targets (:func:`shard_targets`);
    the ranks' ``(lse, tgt)`` are gathered and merged
    (:func:`merge_vocab_shards`), ``dh`` is summed over ``model`` and
    ``dE`` stays the rank's own."""

    @staticmethod
    def forward(ctx, h, e, target, vocab_shard):
        local = target if vocab_shard is None else shard_targets(target, vocab_shard[1])
        lse, tgt = fused_ce_fwd(h, e, local)
        if vocab_shard is not None:
            tp = vocab_shard[0]
            both = torch.stack([lse, tgt])
            parts = [torch.empty_like(both) for _ in range(tp.size)]
            dist.all_gather(parts, both, group=tp.group)
            parts = torch.stack(parts)
            lse, tgt = merge_vocab_shards(parts[:, 0], parts[:, 1])
        ctx.save_for_backward(h, e, target, local, lse)
        ctx.vocab_shard = vocab_shard
        return (lse - tgt) * (target >= 0)

    @staticmethod
    def backward(ctx, g_nll):
        h, e, target, local, lse = ctx.saved_tensors
        coef = torch.where(target >= 0, g_nll.float(), 0.0)
        dh, de = fused_ce_bwd(h, e, local, lse, coef)
        if ctx.vocab_shard is not None:
            dh = all_reduce_model(dh, ctx.vocab_shard[0])
        return dh, de, None, None


def fused_cross_entropy_from_hidden(
    hidden: torch.Tensor,  # (B, L, D)
    embedding: torch.Tensor,  # (V, D) tied LM-head table, in hidden's dtype
    targets: torch.Tensor,  # (B, L) int ids with IGNORE_ID masked out
    ignore_id: int = IGNORE_ID,
    denominator: Optional[torch.Tensor] = None,
    vocab_shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused tied-head CE. Returns ``(loss, num_valid)`` like
    :func:`cross_entropy_loss`; on a CUDA device the logits never reach
    device memory. The loss is the nll sum over ``denominator`` when one is
    given (a rank's share of a mean over the ranks' tokens), else over the
    valid count. ``vocab_shard``: ``(TPGroup, offset)`` when ``embedding``
    is this rank's rows of a table split over the ``model`` axis (every
    rank of the group then gets the same loss)."""
    D = hidden.shape[-1]
    t = targets.reshape(-1)
    valid = t != ignore_id
    safe = torch.where(valid, t, -1)  # ignored rows match no vocab column
    nll = _FusedCETokens.apply(hidden.reshape(-1, D), embedding, safe, vocab_shard)
    n_valid = valid.sum()
    if denominator is None:
        denominator = n_valid.clamp_min(1)
    return nll.sum() / denominator, n_valid


def cross_entropy_from_hidden(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    targets: torch.Tensor,
    ignore_id: int = IGNORE_ID,
    denominator: Optional[torch.Tensor] = None,
    vocab_shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tied-head CE from hidden states, as the train tasks call it: the fused
    kernels on a CUDA tensor (or an error), their plain versions on a CPU
    tensor; vocabulary-parallel with a ``vocab_shard``."""
    return fused_cross_entropy_from_hidden(hidden, embedding, targets, ignore_id, denominator,
                                           vocab_shard)
