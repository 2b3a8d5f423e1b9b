"""Train state and the train step (counterpart of
:mod:`pixparse_tpu.framework.train_state`, its one-device part: no mesh).

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from pixparse_tpu_torch.framework.optimization import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int  # train steps taken, skipped ones included (host counter)
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    seed: int  # base dropout seed; the stream of a step is dropout_seed(seed, step, idx)

    def lr(self, schedule, grad_accum_steps: int = 1) -> float:
        """Current learning rate (host side, for logging)."""
        return float(schedule(self.step // max(1, grad_accum_steps)))


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, seed: int = 0) -> TrainState:
    """State over ``model``'s named parameters (shared parameters once)."""
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), seed=seed + 1)


def dropout_seed(seed: int, step: int, micro_idx: int = 0) -> int:
    """Seed of the dropout stream of one micro-batch of one step: a fixed
    mix of its three coordinates (splitmix-style), below 2**63."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro_idx * 0x94D049BB133111EB)
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


def make_train_step(
    loss_fn: Callable,  # (batch) -> (loss, aux_dict), through the model that owns the params
    optimizer: Optimizer,
    reseed: Optional[Callable[[int], None]] = None,  # points the dropout stream at a seed
    skip_nonfinite: bool = True,
    grad_accum_steps: int = 1,
) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; see the module
    docstring. ``state.params`` are updated in place and the returned state
    shares them."""

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

        with torch.no_grad():
            grad_norm = global_norm(grads)
            updates, new_opt_state = optimizer.update(
                dict(zip(params, grads)), state.opt_state, params
            )
            metrics = dict(loss=loss, grad_norm=grad_norm)
            updates = list(updates.values())
            if skip_nonfinite:
                ok = torch.isfinite(grad_norm) & torch.isfinite(loss)
                updates = [torch.where(ok, u, 0.0) for u in updates]
                new_opt_state = _where_tree(ok, new_opt_state, state.opt_state)
                metrics["nonfinite"] = (~ok).to(torch.int32)
            torch._foreach_add_(list(params.values()), updates)
        metrics.update(aux)
        new_state = dataclasses.replace(state, step=state.step + 1, opt_state=new_opt_state)
        return new_state, metrics

    return train_step
