"""Train state and the train step (counterpart of
:mod:`pixparse_tpu.framework.train_state`), for one process alone or over a
mesh of processes (:mod:`pixparse_tpu_torch.parallel.mesh`).

:class:`TrainState` holds the step counter, the model's parameters by name
(the very tensors the model computes with; the step updates them in place),
the optimizer state and the base dropout seed. :func:`make_train_step` builds
``train_step(state, batch) -> (state, metrics)``:

- loss and gradients (summed over micro-batches and averaged when
  ``grad_accum_steps > 1``: the batch is then STACKED, every leaf shaped
  ``(accum, micro_B, ...)``, nested dicts included, and one update follows);
- ``grad_norm`` (global L2 norm), the optimizer update, the new parameters;
- the non-finite skip: when the loss or the gradient norm is not finite the
  parameters and the optimizer state stay as they were, the step still
  counts, and ``metrics['nonfinite']`` is 1. The decision stays on the
  device (``torch.where`` on the updates and the state), so the host never
  waits for it; ``metrics`` holds device tensors that are read only when
  they are logged;
- a dropout stream per ``(seed, step, micro-batch index)``: a restart at the
  same step repeats the masks.

Under a mesh (``create_train_state(..., mesh=)``) the model is FSDP2-wrapped
and ``state.params`` are its ``DTensor`` shards:

- the step runs ``loss.backward()`` and reads the reduced ``p.grad`` (FSDP2
  hands ``torch.autograd.grad`` nothing for a sharded parameter); a
  parameter that needs a gradient and has none raises;
- accumulation syncs gradients on the last micro-batch only
  (``set_requires_gradient_sync``), then divides their sum: the mean over
  micro-batches, as in one process;
- a rank's loss is its share of the global one: their mean over the
  ``(data, fsdp)`` ranks, which is the mean FSDP2 takes of the gradients, is
  the global loss (a token-mean loss divides its local sum by the global
  count over the ranks: ``BaseCrullerTrainTask``). ``metrics`` hold those
  means, the same on every rank;
- the optimizer runs on the local shards, whole-tensor norms summed over the
  shards; the non-finite skip reads the global loss and gradient norm, so
  every rank decides alike;
- each ``(data, fsdp)`` rank draws its own dropout stream: that rank
  joins the seed's mix. The ranks of one ``model`` group share it, so the
  masks on replicated activations (residual, embedding, attention and FFN
  outputs after their all-reduce) are equal across the group and its
  replicated streams stay equal; a mask inside a rank's own FFN columns
  comes from a second stream that also mixes in the model rank
  (``reseed`` seeds both: ``BartCausalDecoder.reseed_dropout``), so the
  group's shards draw different masks.

Under tensor parallelism (``model > 1``) ``state.tp`` and
``state.tp_layouts`` say how each split parameter's shard sits in the
whole one (:mod:`pixparse_tpu_torch.parallel.tensor_parallel`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from pixparse_tpu_torch.framework.optimization import Optimizer, global_norm
from pixparse_tpu_torch.framework.profiling import span


@dataclasses.dataclass
class TrainState:
    step: int  # train steps taken, skipped ones included (host counter)
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    seed: int  # base dropout seed; the stream of a step is dropout_seed(seed, step, idx)
    tp: Any = None  # TPGroup of a model split over the mesh's model axis
    tp_layouts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def lr(self, schedule, grad_accum_steps: int = 1) -> float:
        """Current learning rate (host side, for logging)."""
        return float(schedule(self.step // max(1, grad_accum_steps)))


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, seed: int = 0,
                       mesh=None) -> TrainState:
    """State over ``model``'s named parameters (shared parameters once).
    With a ``mesh`` the model is first FSDP2-wrapped over its ``(data,
    fsdp)`` axes (:func:`~pixparse_tpu_torch.parallel.mesh.shard_model`),
    and the parameters and optimizer moments are ``DTensor`` shards."""
    if mesh is not None:
        from pixparse_tpu_torch.parallel.mesh import shard_model

        shard_model(model, mesh)
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), seed=seed + 1,
                      tp=getattr(model, "tp", None),
                      tp_layouts=dict(getattr(model, "tp_layouts", {})))


def dropout_seed(seed: int, step: int, micro_idx: int = 0, rank: int = 0) -> int:
    """Seed of the dropout stream of one micro-batch of one step on one
    ``(data, fsdp)`` rank: a fixed mix of its four coordinates
    (splitmix-style), below 2**63. Rank 0 draws what a process alone
    draws."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro_idx * 0x94D049BB133111EB
         + rank * 0xD1B54A32D192ED03)
    x &= (1 << 64) - 1
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & ((1 << 64) - 1)
    x ^= x >> 32
    return x & ((1 << 63) - 1)


def _index_tree(tree, idx: int):
    """Entry ``idx`` of every tensor leaf, over nested dicts (a stacked
    batch -> one micro-batch)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, idx) for k, v in tree.items()}
    return tree[idx]


def _where_tree(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` else ``old``, leaf by leaf over nested dicts."""
    if isinstance(new, dict):
        return {k: _where_tree(ok, v, old[k]) for k, v in new.items()}
    return torch.where(ok, new, old)


def _apply_update(optimizer, params, grads, opt_state, loss, skip_nonfinite, shards=None):
    """The gradient norm, the optimizer update, the non-finite skip, and the
    parameters moved in place; ``(new_opt_state, metrics)``. ``shards``:
    the tensors are local shards (:class:`~pixparse_tpu_torch.parallel.mesh.ShardedParams`)."""
    grad_norm = global_norm(grads, shards)
    updates, new_opt_state = optimizer.update(
        dict(zip(params, grads)), opt_state, params, shards=shards)
    metrics = dict(loss=loss, grad_norm=grad_norm)
    updates = list(updates.values())
    if skip_nonfinite:
        ok = torch.isfinite(grad_norm) & torch.isfinite(loss)
        updates = [torch.where(ok, u, 0.0) for u in updates]
        new_opt_state = _where_tree(ok, new_opt_state, opt_state)
        metrics["nonfinite"] = (~ok).to(torch.int32)
    torch._foreach_add_(list(params.values()), updates)
    return new_opt_state, metrics


def make_train_step(
    loss_fn: Callable,  # (batch) -> (loss, aux_dict), through the model that owns the params
    optimizer: Optimizer,
    reseed: Optional[Callable[[int], None]] = None,  # points the dropout stream at a seed
    skip_nonfinite: bool = True,
    grad_accum_steps: int = 1,
    mesh=None,  # the DeviceMesh the state was created on
    module: Optional[torch.nn.Module] = None,  # with a mesh: the FSDP2 root
) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; see the module
    docstring. ``state.params`` are updated in place and the returned state
    shares them."""
    if mesh is not None:
        return _make_sharded_train_step(
            loss_fn, optimizer, reseed, skip_nonfinite, grad_accum_steps, mesh, module)

    def grads_of(params, batch, seed):
        if reseed is not None:
            reseed(seed)
        loss, aux = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params.values())]
        return loss.detach(), aux, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        with span("train.forward_backward"):
            if grad_accum_steps > 1:
                loss, grads, aux = None, None, {}
                for idx in range(grad_accum_steps):
                    micro = _index_tree(batch, idx)
                    l, aux, g = grads_of(params, micro, dropout_seed(state.seed, state.step, idx))
                    if grads is None:
                        loss, grads = l, list(g)
                    else:
                        loss = loss + l
                        torch._foreach_add_(grads, g)
                loss = loss / grad_accum_steps
                torch._foreach_div_(grads, float(grad_accum_steps))
            else:
                loss, aux, grads = grads_of(params, batch, dropout_seed(state.seed, state.step))

        with torch.no_grad(), span("train.optimizer"):
            new_opt_state, metrics = _apply_update(
                optimizer, params, grads, state.opt_state, loss, skip_nonfinite)
        metrics.update(aux)
        new_state = dataclasses.replace(state, step=state.step + 1, opt_state=new_opt_state)
        return new_state, metrics

    return train_step


def _local_tree(tree):
    """Every ``DTensor`` leaf of nested dicts -> its local tensor."""
    from pixparse_tpu_torch.parallel.mesh import local

    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    return local(tree)


def _store_tree(old, new):
    """``new`` (local tensors) written into the ``DTensor`` leaves of ``old``
    in place; other leaves replaced. Returns the tree to keep."""
    from pixparse_tpu_torch.parallel.mesh import is_sharded

    if isinstance(old, dict):
        return {k: _store_tree(v, new[k]) for k, v in old.items()}
    if is_sharded(old):
        old.to_local().copy_(new)
        return old
    return new


def _make_sharded_train_step(loss_fn, optimizer, reseed, skip_nonfinite, grad_accum_steps,
                             mesh, module):
    """The train step over a mesh (FSDP2 parameters); see the module
    docstring."""
    from pixparse_tpu_torch.parallel.mesh import (
        ShardedParams,
        data_parallel_rank,
        mean_over_ranks,
    )

    if module is None or not hasattr(module, "set_requires_gradient_sync"):
        raise ValueError("a train step over a mesh needs the FSDP2-wrapped model (module=)")
    rank = data_parallel_rank(mesh)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        for p in params.values():
            p.grad = None
        loss, aux = None, {}
        for idx in range(grad_accum_steps):
            micro = _index_tree(batch, idx) if grad_accum_steps > 1 else batch
            module.set_requires_gradient_sync(idx == grad_accum_steps - 1)
            if reseed is not None:
                reseed(dropout_seed(state.seed, state.step, idx, rank))
            l, aux = loss_fn(micro)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        missing = [n for n, p in params.items() if p.requires_grad and p.grad is None]
        if missing:
            raise RuntimeError(
                f"{len(missing)} parameters that need a gradient got none in the sharded "
                f"train step (first: {missing[:3]}); a mesh step never fills them with zeros"
            )
        with torch.no_grad():
            grads = [p.grad.to_local() for p in params.values()]
            if grad_accum_steps > 1:
                loss = loss / grad_accum_steps
                torch._foreach_div_(grads, float(grad_accum_steps))
            loss = mean_over_ranks(mesh, loss)
            aux = {k: mean_over_ranks(mesh, v) if isinstance(v, torch.Tensor) else v
                   for k, v in aux.items()}
            new_opt, metrics = _apply_update(
                optimizer, _local_tree(params), grads, _local_tree(state.opt_state), loss,
                skip_nonfinite, ShardedParams(params, mesh, state.tp, state.tp_layouts))
            opt_state = _store_tree(state.opt_state, new_opt)
            for p in params.values():
                p.grad = None
        metrics.update(aux)
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    return train_step


def make_eval_step(apply_fn: Callable, mesh=None) -> Callable:
    """``eval_step(batch) -> out``: ``apply_fn`` on the rank's local batch
    without gradients (eval keeps whole parameters on every rank, so there
    is nothing to gather; ``mesh`` is kept for the JAX package's signature)."""

    def eval_step(batch):
        with torch.no_grad():
            return apply_fn(batch)

    return eval_step
