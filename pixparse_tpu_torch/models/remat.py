"""Rematerialisation (activation checkpointing) of the train forward:
the JAX package's remat modes (``models/vit.py::mlp_forward`` and
``_remat_policy``, the ``nn.remat`` wraps of its ViT/Swin blocks and decoder
layers) on :func:`torch.utils.checkpoint.checkpoint` (non-reentrant).

Modes, as ``task/cruller_base.py::resolve_remat`` gives them:

- ``False``: nothing is recomputed;
- ``'mlp'``: each MLP (fc1 -> GELU -> fc2) is checkpointed whole; its input
  is the only residual;
- ``'gelu'``: GELU + fc2 are checkpointed; fc1's output is the residual, and
  the backward recomputes only the GELU;
- ``True`` (``'full'``): each whole block (ViT block, Swin block, decoder
  layer) is checkpointed;
- ``'dots'``: the same cut as ``'full'`` under a selective policy that saves
  the outputs of matrix products without batch dimensions (``aten.mm`` and
  ``aten.addmm``: the Linear layers) and recomputes everything else, as JAX's
  ``dots_with_no_batch_dims_saveable``.

Dropout under recompute: ``torch.utils.checkpoint`` restores only the default
CPU and CUDA generators, but the port draws its dropout masks from explicit
:class:`torch.Generator` objects. :func:`checkpoint_region` takes those
generators' states before the region runs and sets them again for the
recompute (restoring the states it found afterwards), so the recompute draws
the forward's masks.

The CUDA kernels launch through ctypes, which torch's dispatcher does not
see: a selective policy can neither save nor replay them. Under ``'full'``
and ``'dots'`` they run again in the recompute, and their launch counters
count it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

MODES = (False, True, "full", "dots", "mlp", "gelu")
MLP_MODES = ("mlp", "gelu")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def block_mode(remat) -> Optional[str]:
    """The whole-block cut of a remat mode: ``'full'``, ``'dots'`` or None."""
    if remat is True or remat == "full":
        return "full"
    return "dots" if remat == "dots" else None


def mlp_mode(remat) -> Optional[str]:
    """The MLP cut of a remat mode: ``'mlp'``, ``'gelu'`` or None."""
    return remat if remat in MLP_MODES else None


def set_remat(module: torch.nn.Module, remat) -> None:
    """Give every remat-aware submodule (those with a ``remat_mode``) the
    mode ``remat``."""
    if remat is None:
        remat = False
    if not (isinstance(remat, bool) or remat in ("full", "dots", "mlp", "gelu")):
        raise ValueError(f"unknown remat mode {remat!r} (one of {MODES})")
    for m in module.modules():
        if hasattr(m, "remat_mode"):
            m.remat_mode = remat


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _replaying(fn: Callable, generators: Sequence[torch.Generator]) -> Callable:
    """``fn`` whose second and later calls (the recompute) start from the
    generators' states of the first call, and leave the generators as they
    found them."""
    states = [g.get_state() for g in generators]
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        found = [g.get_state() for g in generators]
        for g, s in zip(generators, states):
            g.set_state(s)
        try:
            return fn(*args)
        finally:
            for g, s in zip(generators, found):
                g.set_state(s)

    return run


def checkpoint_region(fn: Callable, *args, dots: bool = False,
                      generator: Union[None, torch.Generator, Sequence[torch.Generator]] = None):
    """``fn(*args)`` with its activations recomputed in the backward (the
    plain call when gradients are off). ``dots``: keep the Linear layers'
    outputs (the ``'dots'`` policy). ``generator``: the dropout generator
    (or generators) ``fn`` draws from, replayed in the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kwargs = {}
    if dots:
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if generator is not None:
        fn = _replaying(fn, (generator,) if isinstance(generator, torch.Generator)
                        else tuple(generator))
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)
