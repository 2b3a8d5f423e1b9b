"""Dense layer and dropout for a forward pass whose compute dtype differs
from the parameter dtype.

Training keeps fp32 master weights and runs the forward in bf16: flax casts
each parameter to the module's compute dtype where it is used, and so does
:class:`Linear` here (the input's dtype is the compute dtype). With the
whole model already in the compute dtype, as the eval tasks hold it, the
cast is the identity.

:func:`dropout` draws its keep mask from an explicit :class:`torch.Generator`
(``torch.nn.functional.dropout`` takes none), so a train step can derive the
masks from ``(seed, step, micro-batch index)`` and a restart at the same step
repeats them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.parallel.tensor_parallel import reduce_from_model


class Linear(nn.Linear):
    """``nn.Linear`` (same parameter names) with weight and bias cast to the
    input's dtype at use. A row-parallel layer (``tp_reduce``, set by
    :func:`~pixparse_tpu_torch.parallel.tensor_parallel.parallelize`) sums
    its partial output over the ``model`` ranks, then adds the bias."""

    tp_reduce = None  # TPGroup of a row-parallel layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.tp_reduce is None:
            return F.linear(x, self.weight.to(x.dtype), bias)
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.tp_reduce)
        return y if bias is None else y + bias


def dropout(
    x: torch.Tensor,
    rate: float,
    training: bool,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverted dropout, flax semantics: keep with probability ``1 - rate``
    and scale the kept values by ``1 / (1 - rate)``. The identity when not
    training or ``rate == 0``. ``generator`` must live on ``x``'s device."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        keep, generator=generator
    )
    return torch.where(mask, x / keep, torch.zeros_like(x))
