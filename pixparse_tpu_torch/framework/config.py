"""Eval config dataclass (counterpart of :mod:`pixparse_tpu.framework.config`;
the training configs arrive with the training slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TaskEvalCfg:
    dtype: Optional[str] = None  # 'bfloat16'/'bf16'/'float16'/'fp16' -> bf16, else fp32
    amp: bool = True  # kept for flag parity; the compute dtype comes from `dtype`
    attn_impl: str = "auto"  # 'auto' (flash on CUDA) | 'xla' (plain) | 'flash'
    model_name: str = ""
    # the port's explicit device: 'cuda', 'cuda:N' or 'cpu'; without CUDA,
    # 'cuda' raises instead of falling back to the CPU
    device: str = "cuda"
    kv_cache_dtype: str = "bf16"  # 'int8' is not ported yet (raises)
    lm_head_dtype: str = "bf16"  # 'int8' is not ported yet (raises)
