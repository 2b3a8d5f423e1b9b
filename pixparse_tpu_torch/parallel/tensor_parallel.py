"""Tensor parallelism over the mesh's ``model`` axis (the JAX package's
``shard_map`` over ``model`` with heads, MLP and vocabulary split there),
Megatron-style, with explicit collectives.

- The plan comes from the logical rules (:mod:`pixparse_tpu_torch.parallel.mesh`):
  :func:`param_logical_axes` names each parameter's axes in the port's
  (torch) layout, :func:`~pixparse_tpu_torch.parallel.mesh.logical_sharding`
  maps them to mesh axes, and the dim that lands on ``model`` is the one
  split. Column-parallel Linears (``('heads'|'mlp', 'embed')``) keep their
  output rows, their bias with them; row-parallel ones (``('embed',
  'heads'|'mlp')``) keep their input columns, all-reduce their output
  over ``model`` and add the whole bias after it. The tied token table
  (``('vocab', 'vocab_embed')``) keeps ``ceil(V / model)`` rows (the last
  rank fewer). The Swin relative-position table keeps its heads' columns.
- A fused q/k/v projection is split by heads inside each of q, k and v
  (:class:`TPLayout` ``groups=3``): rank r holds q, k and v of the same
  heads. (The JAX package splits the fused kernel's ``3C`` columns
  contiguously; the layouts differ, the numbers do not.)
- Every tensor-parallel region starts with :func:`copy_to_model` (identity
  forward, gradient all-reduced over ``model`` in the backward) and ends
  with :func:`reduce_from_model` (output all-reduced in the forward): the
  Megatron ``f`` / ``g`` pair. The token lookup is a masked local lookup
  plus that all-reduce; the loss takes the vocabulary shard and its row
  offset (:mod:`pixparse_tpu_torch.ops.loss`).
- Dropout follows Megatron's split: a mask on a replicated activation
  comes from the ``(data, fsdp)`` rank's stream, the same on every rank of
  a model group; a mask inside a rank's own FFN columns comes from a
  second stream whose seed also mixes in the model rank
  (:func:`shard_seed`), so the shards draw different masks, as one mask
  over the whole tensor does.
- Every collective reduces in fp32 (gloo takes no bfloat16 on every build;
  fp32 keeps the sums of bf16 partials from rounding twice).

:func:`parallelize` cuts a whole model's parameters to this rank's shards
and marks the modules; the model then holds plain local tensors, which
FSDP2 shards further over ``(data, fsdp)`` in training. Eval cuts the
same way and decodes with every rank's caches holding its own heads; the
logits are gathered whole over the vocabulary shards
(:meth:`~pixparse_tpu_torch.models.bart.BartCausalDecoder.whole_logits`),
so every rank of a group picks the same tokens. :func:`gather_whole` and
:meth:`TPLayout.take` move between a shard and the whole tensor.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This rank's place on the ``model`` axis."""

    group: Any  # the ProcessGroup of the rank's model axis
    rank: int
    size: int
    mesh: Any = None  # the model axis as a 1-D DeviceMesh (checkpoints' layout)


# --------------------------------------------------------------------------
# the f / g pair and the reductions
# --------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in fp32, returned in ``t``'s dtype (a
    new tensor)."""
    out = t.detach().to(torch.float32).clone().contiguous()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Megatron ``f``: the input of a tensor-parallel region (identity;
    its gradient summed over ``model``). The identity without ``tp``."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Megatron ``g``: partial outputs summed over ``model`` (the gradient
    passes as it is). The identity without ``tp``."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def all_reduce_model(t: torch.Tensor, tp: TPGroup, op=None) -> torch.Tensor:
    """``t`` reduced over ``model`` (no gradient), in ``t``'s dtype."""
    return _all_reduce(t, tp.group, op)


def shard_seed(seed: int, rank: int) -> int:
    """Seed of model rank ``rank``'s own dropout stream (masks inside its
    FFN columns), from the group's shared ``seed``: a fixed splitmix-style
    mix, below 2**63, different for every rank and from ``seed``."""
    m = (1 << 64) - 1
    x = (seed + (rank + 1) * 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, tp: Optional[TPGroup],
                             offset: int) -> torch.Tensor:
    """Lookup in a table whose rows ``[offset, offset + len(weight))`` this
    rank holds: the rows it has, zeros elsewhere, summed over ``model``
    (exactly one rank holds each id)."""
    if tp is None:
        return torch.nn.functional.embedding(ids, weight)
    local = ids - offset
    inside = (local >= 0) & (local < weight.shape[0])
    out = torch.nn.functional.embedding(torch.where(inside, local, 0), weight)
    return reduce_from_model(out * inside[..., None].to(out.dtype), tp)


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Where a rank's shard sits in the whole tensor: along ``dim`` the
    whole is ``n`` long, ``groups`` equal blocks (3 for a fused q/k/v),
    each cut into ``size`` runs of ``ceil(block / size)`` (the last ones
    shorter: the JAX package's ``vs_raw = ceil(V / model)``); rank r holds
    run r of every block, in block order."""

    dim: int
    n: int
    groups: int = 1

    def spans(self, rank: int, size: int) -> List[Tuple[int, int]]:
        """``[(start, stop)]`` of rank ``rank``'s runs along ``dim``."""
        block = self.n // self.groups
        chunk = -(-block // size)
        return [(k * block + min(rank * chunk, block), k * block + min((rank + 1) * chunk, block))
                for k in range(self.groups)]

    def offset(self, rank: int, size: int) -> int:
        """First row of rank ``rank``'s (first) run."""
        return self.spans(rank, size)[0][0]

    def local_size(self, rank: int, size: int) -> int:
        return sum(b - a for a, b in self.spans(rank, size))

    def take(self, whole: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """Rank ``rank``'s shard of ``whole`` (a copy)."""
        if whole.shape[self.dim] != self.n:
            raise ValueError(f"dim {self.dim} of {tuple(whole.shape)} is not {self.n} long")
        parts = [whole.narrow(self.dim, a, b - a) for a, b in self.spans(rank, size)]
        return torch.cat(parts, self.dim).contiguous() if len(parts) > 1 \
            else parts[0].contiguous().clone()

    def assemble(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's shard, in rank order."""
        pieces = []
        for k in range(self.groups):
            for s in shards:
                m = s.shape[self.dim] // self.groups
                pieces.append(s.narrow(self.dim, k * m, m))
        return torch.cat(pieces, self.dim)


def gather_whole(shard: torch.Tensor, layout: TPLayout, tp: TPGroup) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` (a collective over
    ``model``)."""
    longest = layout.local_size(0, tp.size)
    pad = longest - shard.shape[layout.dim]
    padded = shard.detach().contiguous()
    if pad:
        widths = [0, 0] * (shard.dim() - 1 - layout.dim) + [0, pad]
        padded = torch.nn.functional.pad(padded, widths)
    parts = [torch.empty_like(padded) for _ in range(tp.size)]
    dist.all_gather(parts, padded, group=tp.group)
    return layout.assemble([p.narrow(layout.dim, 0, layout.local_size(r, tp.size))
                            for r, p in enumerate(parts)])


# --------------------------------------------------------------------------
# the plan: logical axes of the port's parameters
# --------------------------------------------------------------------------

# (pattern on the parameter name, logical axes in the port's layout); a
# torch Linear weight is (out, in), the transpose of a flax kernel. Names
# no pattern matches are replicated.
_LOGICAL_AXES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|\.)qkv\.weight$", ("heads", "embed")),
    (r"(^|\.)qkv\.bias$", ("heads",)),
    (r"attn\.proj\.weight$", ("embed", "heads")),
    (r"_attn\.[qkv]_proj\.weight$", ("heads", "embed")),
    (r"_attn\.[qkv]_proj\.bias$", ("heads",)),
    (r"_attn\.out_proj\.weight$", ("embed", "heads")),
    (r"(^|\.)fc1\.weight$", ("mlp", "embed")),
    (r"(^|\.)fc1\.bias$", ("mlp",)),
    (r"(^|\.)fc2\.weight$", ("embed", "mlp")),
    (r"(embed_tokens|lm_head)\.weight$", ("vocab", "vocab_embed")),
    (r"relative_position_bias_table$", (None, "heads")),
    (r"embed_positions\.weight$", ("length", "embed")),
    (r"reduction\.weight$", (None, "embed")),
    (r"pos_embed$", (None, "image_length", "embed")),
    (r"cls_token$", (None, None, "embed")),
)
_FUSED = re.compile(r"(^|\.)qkv\.(weight|bias)$")  # q, k and v in one projection


def param_logical_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of parameter ``name`` in the port's layout (the
    JAX package's annotations, transposed for torch Linears); rank-1
    parameters without a pattern are ``('embed',)`` (norms, row biases)."""
    for pattern, axes in _LOGICAL_AXES:
        if re.search(pattern, name) and len(axes) == ndim:
            return axes
    return ("embed",) if ndim == 1 else (None,) * ndim


def param_layout(name: str, shape) -> Optional[TPLayout]:
    """This parameter's :class:`TPLayout` on the ``model`` axis, or None
    (replicated). The split dim is the one whose logical axis
    ``DEFAULT_LOGICAL_RULES`` map onto ``model``. Unlike XLA's layout, a
    column-parallel Linear's bias is split with its rows (each rank adds
    its own slice)."""
    from pixparse_tpu_torch.parallel.mesh import resolve_logical

    resolved = resolve_logical(param_logical_axes(name, len(shape)))
    dims = [d for d, r in enumerate(resolved)
            if r == "model" or (isinstance(r, tuple) and "model" in r)]
    if not dims:
        return None
    return TPLayout(dims[0], shape[dims[0]], 3 if _FUSED.search(name) else 1)


def tp_plan(model: torch.nn.Module) -> Dict[str, TPLayout]:
    """Every split parameter of ``model`` by its ``state_dict`` name
    (shared parameters under each of their names)."""
    plan = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        layout = param_layout(name, p.shape)
        if layout is not None:
            plan[name] = layout
    return plan


def _check_divisible(model, tp: TPGroup):
    from pixparse_tpu_torch.models.bart import _Projections
    from pixparse_tpu_torch.models.swin import WindowAttention
    from pixparse_tpu_torch.models.vit import Attention

    for name, m in model.named_modules():
        if isinstance(m, (Attention, WindowAttention, _Projections)) and m.num_heads % tp.size:
            raise ValueError(
                f"{name}: {m.num_heads} heads do not split over model={tp.size} ranks")


def _decoder_of(model):
    """The decoder of a model :func:`parallelize` takes (None for the
    classifier); a ``NotImplementedError`` naming what it takes for any
    other model."""
    from pixparse_tpu_torch.models.bart import BartCausalDecoder
    from pixparse_tpu_torch.models.cruller import Cruller
    from pixparse_tpu_torch.models.pix2struct import Pix2StructEncoder
    from pixparse_tpu_torch.models.swin import Swin
    from pixparse_tpu_torch.models.vit import ViT
    from pixparse_tpu_torch.task.task_cruller_finetune_xent import CrullerClassifier

    if isinstance(model, Cruller) and isinstance(model.encoder, (ViT, Swin, Pix2StructEncoder)) \
            and isinstance(model.decoder, BartCausalDecoder):
        return model.decoder
    if isinstance(model, CrullerClassifier) and isinstance(model.encoder["trunk"], ViT):
        return None
    raise NotImplementedError(
        "tensor parallelism (--task.mesh.model > 1) takes a Cruller (ViT, Swin or pix2struct "
        "encoder, BART decoder) or the xent task's CrullerClassifier (ViT encoder), not "
        f"{type(model).__name__}")


def parallelize(model: torch.nn.Module, tp: TPGroup) -> Dict[str, TPLayout]:
    """Cut ``model`` (whole and alike on every rank: a ``Cruller`` with a
    ViT, Swin or pix2struct encoder, or the classifier of
    ``cruller_finetune_xent``) to this rank's shards in place and mark its
    tensor-parallel modules; returns the plan (also ``model.tp_layouts``).
    The tied head stays tied to the cut table. What no logical axis maps
    to ``model`` stays whole: pix2struct's patch, row and column
    embeddings, the classifier's ``final_fc``."""
    from pixparse_tpu_torch.models.bart import BartDecoderLayer, _Projections
    from pixparse_tpu_torch.models.swin import WindowAttention
    from pixparse_tpu_torch.models.vit import Attention, Mlp
    from pixparse_tpu_torch.ops.dense import Linear

    decoder = _decoder_of(model)
    _check_divisible(model, tp)
    plan = tp_plan(model)
    done = set()
    for name, p in list(model.named_parameters(remove_duplicate=False)):
        if name not in plan or id(p) in done:
            continue
        path, _, attr = name.rpartition(".")
        setattr(model.get_submodule(path), attr, torch.nn.Parameter(
            plan[name].take(p.data, tp.rank, tp.size), requires_grad=p.requires_grad))
        done.add(id(p))
    if decoder is not None:
        decoder.lm_head.weight = decoder.decoder.embed_tokens.weight  # re-tie
        decoder.vocab_offset = TPLayout(0, decoder.cfg.vocab_size).offset(tp.rank, tp.size)
        decoder.tp = tp
    for m in model.modules():
        if isinstance(m, (Attention, Mlp, WindowAttention, _Projections, BartDecoderLayer)):
            m.tp = tp
    row_parallel = {n.rsplit(".", 1)[0] for n, lay in plan.items() if lay.dim == 1}
    for name, m in model.named_modules():
        if isinstance(m, Linear) and name in row_parallel:
            m.tp_reduce = tp  # output summed over model, then the bias
    model.tp = tp
    model.tp_layouts = plan
    return plan
