"""How the reference rounds the operands of its products.

``fp32``: no rounding; matrix products in true float32 (TF32 off, see
:func:`exact_matmuls`). ``fp8``: the control. Both operands of every
product (dense layers, attention scores and values, the tied head) are
rounded to float8 e4m3 with one scale per tensor (its absolute maximum to
448), as an fp8 recipe does, and the product accumulates in float32. The
gradient passes the rounding unchanged (straight through), so a backward
pass differs from the exact one only through the rounded forward values
it multiplies with.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
KINDS = ("fp32", "fp8")


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, returned in ``t``'s
    dtype; the gradient passes unchanged."""
    x = t.detach()
    scale = E4M3_MAX / x.abs().amax().float().clamp_min(1e-30)
    rounded = (x.float() * scale).to(torch.float8_e4m3fn).float().div(scale).to(t.dtype)
    return t + (rounded - x)


class Numerics:
    def __init__(self, kind: str = "fp32"):
        if kind not in KINDS:
            raise ValueError(f"numerics {kind!r} (one of {KINDS})")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.kind == "fp8" else t

    def linear(self, x, weight, bias=None):
        return F.linear(self.q(x), self.q(weight), bias)

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))
