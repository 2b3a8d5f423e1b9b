"""Profiling and MFU accounting (counterpart of
:mod:`pixparse_tpu.framework.profiling`).

- :func:`trace`: a ``torch.profiler`` capture context (CPU and CUDA
  activities) that writes a chrome trace into a directory;
- analytic matmul-FLOP accounting for the Cruller train step
  (:func:`cruller_train_flops`, ViT or Swin encoder: :func:`swin_encoder_flops`)
  and :func:`mfu` against the dense bf16
  tensor-core peak of the card the step runs on.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace into ``logdir/trace.json`` (no-op
    when ``logdir`` is empty)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    _logger.info("profiler trace written to %s", logdir)


# dense bf16 tensor-core peak FLOP/s by substring of the CUDA device name
# (NVIDIA data sheets, without sparsity)
_PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H200", 989e12),
    ("H100", 989e12),
    ("A100", 312e12),
)


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak of the CUDA device (``None`` on the CPU or an unknown card)."""
    import torch

    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    return None


def transformer_layer_flops(L: int, D: int, F: int, cross_Lk: int = 0) -> float:
    """Forward matmul FLOPs for one transformer layer at sequence length L:
    self-attention projections, score and value products, FFN (and
    cross-attention when ``cross_Lk`` > 0)."""
    self_attn = 8 * L * D * D + 4 * L * L * D
    ffn = 4 * L * D * F
    cross = 0.0
    if cross_Lk:
        cross = 4 * L * D * D + 4 * cross_Lk * D * D + 4 * L * cross_Lk * D
    return float(self_attn + ffn + cross)


def swin_encoder_flops(cfg) -> float:
    """Forward matmul FLOPs of a Swin encoder: per-stage resolutions and
    widths, WINDOWED attention (the score and value products are N * w^2, not
    N^2), patch merging between stages."""
    gh = cfg.img_size[0] // cfg.patch_size
    gw = cfg.img_size[1] // cfg.patch_size
    w2 = cfg.window_size ** 2
    total = 2 * gh * gw * (cfg.patch_size ** 2 * cfg.in_chans) * cfg.embed_dim
    for stage, depth in enumerate(cfg.depths):
        N = (gh // (2 ** stage)) * (gw // (2 ** stage))
        D = cfg.embed_dim * (2 ** stage)
        per_block = (
            8 * N * D * D  # qkv + out projections
            + 4 * N * w2 * D  # windowed score + value products
            + 4 * N * D * int(D * cfg.mlp_ratio)  # FFN
        )
        total += depth * per_block
        if stage < len(cfg.depths) - 1:
            total += 2 * (N // 4) * (4 * D) * (2 * D)  # patch merging
    return float(total)


def cruller_train_flops(vit_cfg, bart_cfg, batch_size: int, text_len: int) -> float:
    """Matmul FLOPs for one forward+backward Cruller train step (backward =
    2x forward), ViT (full attention) or Swin (windowed) encoder."""
    N = vit_cfg.num_tokens
    if hasattr(vit_cfg, "depths"):  # SwinCfg
        enc = swin_encoder_flops(vit_cfg)
    else:
        D = vit_cfg.embed_dim
        enc = 2 * N * (vit_cfg.patch_size ** 2 * vit_cfg.in_chans) * D
        enc += vit_cfg.depth * transformer_layer_flops(N, D, int(D * vit_cfg.mlp_ratio))
    Dd = bart_cfg.d_model
    dec = bart_cfg.decoder_layers * transformer_layer_flops(
        text_len, Dd, bart_cfg.decoder_ffn_dim, cross_Lk=N
    )
    dec += 2 * text_len * Dd * bart_cfg.vocab_size  # tied LM head
    return 3.0 * batch_size * (enc + dec)


def mfu(flops_per_step: float, step_time_s: float, n_devices: int = 1,
        device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None off the card."""
    peak = peak_flops_per_device(device)
    if peak is None or step_time_s <= 0:
        return None
    return flops_per_step / step_time_s / (peak * n_devices)
