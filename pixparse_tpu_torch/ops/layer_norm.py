"""LayerNorm with fp32 statistics (counterpart of the default path of
:mod:`pixparse_tpu.ops.layer_norm`: ``_ln_ref`` / ``FusedLayerNorm``).

The whole normalisation runs in fp32 and only the result is cast to the
input dtype. The TPU package's opt-in Pallas LayerNorm kernel
(``PIXPARSE_LN_IMPL=pallas``) is not ported yet; the default path there is
this plain math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """Drop-in for ``nn.LayerNorm`` (same ``weight``/``bias`` names) with
    fp32 statistics and the output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps
        )
        return y.to(x.dtype)
