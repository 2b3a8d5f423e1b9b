"""Device kernels by family, from the names the profiler records. The
port's own kernels are named by their CUDA sources (``csrc/*.cu``); the
rest are PyTorch's and the vendor libraries' kernels, grouped by what they
do. The first pattern that matches wins."""

from __future__ import annotations

import re

FAMILIES = (
    ("flash", r"flash_(fwd|bwd)_"),
    ("fused_ce", r"\bce_(gemm|lse_merge|fwd_f32|bwd_f32)_kernel"),
    ("window", r"window_(fwd|bwd)_ring_kernel|window_attn_(bwd_)?f32_kernel|dbias_reduce_kernel"),
    ("decode_attn", r"decode_attn_(split|q8)"),
    ("layer_norm_kernel", r"\bln_(fwd|bwd|partial_sum)_kernel"),
    ("gemm", r"gemm|nvjet|cutlass|xmma|cublas|s\d+gemm|sm\d+_|ampere_|hopper_"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("softmax", r"softmax"),
    ("reduce", r"reduce_kernel|Reduce"),
    ("copy", r"[Mm]emcpy|[Mm]emset|copy|Copy|CatArray|cat_|gather|scatter|index|roll|pad"),
    ("elementwise", r"elementwise|Elementwise|vectorized|unrolled"),
)

_COMPILED = tuple((name, re.compile(pattern)) for name, pattern in FAMILIES)


def family_of(kernel_name: str) -> str:
    for name, pattern in _COMPILED:
        if pattern.search(kernel_name):
            return name
    return "other"
