"""Shared train/eval config dataclasses (counterpart of
:mod:`pixparse_tpu.framework.config`). A process runs on the one device
named by ``device``; under ``torchrun`` the processes form the mesh that
``mesh`` (``--task.mesh.data/fsdp/model``) sizes
(:mod:`pixparse_tpu_torch.parallel.mesh`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class OptimizationCfg:
    optimizer: str = "adamw"
    scheduler: str = "cosine"
    learning_rate: float = 5e-4
    warmup_learning_rate: float = 0.0
    weight_decay: float = 0.02
    eps: float = 1e-6
    clip_grad_value: Optional[float] = None
    clip_grad_mode: Optional[str] = None  # 'norm' | 'value' | 'agc'
    grad_accum_steps: int = 1
    momentum: Optional[float] = None
    betas: Optional[Tuple[float, float]] = None
    layer_decay: Optional[float] = None
    # 'bfloat16': store both Adam moments in bf16 (half the optimizer-state
    # memory and update traffic); the update math still runs in fp32
    optimizer_state_dtype: str = "float32"


@dataclass
class MeshCfg:
    """Mesh axis sizes, in processes (one device each). ``data = 0`` absorbs
    the ranks that ``fsdp * model`` leaves; ``model > 1`` is tensor
    parallelism (:mod:`pixparse_tpu_torch.parallel.tensor_parallel`: heads,
    MLP and vocabulary split over the ``model`` ranks, in training and in
    eval and batched infer)."""

    data: int = 0
    fsdp: int = 1
    model: int = 1


@dataclass
class TaskTrainCfg:
    num_intervals: int = 100
    num_warmup_intervals: int = 5
    eval_frequency: int = 1000
    opt: OptimizationCfg = field(default_factory=OptimizationCfg)
    dtype: Optional[str] = None  # compute dtype: 'bfloat16'/'bf16'/'float16'/None(fp32)
    amp: bool = True  # kept for flag parity; the compute dtype comes from `dtype`
    # None/'auto' = the task's automatic mode ('mlp' when encoder tokens x
    # depth > 20000: donut_base, cruller_large; else none), 'none', 'full',
    # 'dots', 'mlp', 'gelu' (models/remat.py)
    remat: Optional[str] = None
    attn_impl: str = "auto"  # 'auto' (flash on CUDA) | 'xla' (plain) | 'flash'
    model_name: str = ""
    # the port's explicit device: 'cuda', 'cuda:N' or 'cpu'; without CUDA,
    # 'cuda' raises instead of falling back to the CPU
    device: str = "cuda"
    mesh: MeshCfg = field(default_factory=MeshCfg)
    # ship uint8 images host -> device (a quarter of the bytes) and
    # normalize them on the device in the loss (ops/preprocess.py)
    device_preprocess: bool = False
    # train-time augmentation pipeline: 'legacy' (the task default) |
    # 'better' | 'nougat' (data/transforms.py; both need cv2 to train)
    transforms: Optional[str] = None


@dataclass
class TaskEvalCfg:
    dtype: Optional[str] = None  # 'bfloat16'/'bf16'/'float16'/'fp16' -> bf16, else fp32
    amp: bool = True  # kept for flag parity; the compute dtype comes from `dtype`
    attn_impl: str = "auto"  # 'auto' (flash on CUDA) | 'xla' (plain) | 'flash'
    model_name: str = ""
    # the port's explicit device: 'cuda', 'cuda:N' or 'cpu'; without CUDA,
    # 'cuda' raises instead of falling back to the CPU
    device: str = "cuda"
    mesh: MeshCfg = field(default_factory=MeshCfg)
    # ship uint8 canvases host -> device (a quarter of the bytes) and
    # normalize them on the device before the encoder (ops/preprocess.py)
    device_preprocess: bool = False
    # 'int8': quantized cross-attention decode caches (int8 decode kernel)
    kv_cache_dtype: str = "bf16"
    # 'int8': generate() applies the tied head as an exact int8 product
    lm_head_dtype: str = "bf16"
