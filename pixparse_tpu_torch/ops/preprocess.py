"""Image preprocessing on the tensors' device (counterpart of
:mod:`pixparse_tpu.ops.preprocess`): the eval and serving path's
aspect-preserving resize, pad to the canvas, normalize and patchify, batched.

The host half of the ``device_preprocess`` split
(``data/transforms.py::create_transforms(..., normalize=False)``) ships uint8
canvases, a quarter of the float32 bytes; :func:`normalize_images` turns
them into the encoder's fp32 input on the device, with the same bits as the
host's ``_as_float_normalized``: every step is one IEEE-rounded fp32 op, and
the divisors are tensors on the device (PyTorch's CUDA division by a host
scalar multiplies by its reciprocal, which can round otherwise).

The JAX functions are jitted XLA; these are plain PyTorch ops, so there is
no kernel to port. :func:`patchify`'s pixel order is the ViT patch
embedding's ``(p_h, p_w, C)`` (``models/vit.py::PatchEmbed``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _stat(values, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """fp32 pixel values in [0, 255] -> ``(x / 255 - mean) / std``."""
    x = x / torch.full((1,), 255.0, device=x.device)
    return (x - _stat(mean, x)) / _stat(std, x)


def resize_pad_normalize(
    images: torch.Tensor,  # (B, H, W, C) uint8 or float
    target_size: Tuple[int, int],
    mean: Sequence[float] = (0.5,),
    std: Sequence[float] = (0.5,),
    fill: int = 255,
) -> torch.Tensor:
    """Aspect-preserving bilinear resize (antialiased when shrinking, as
    ``jax.image.resize``), centred pad to ``target_size`` with ``fill``,
    then normalize; fp32 ``(B, th, tw, C)``."""
    B, H, W, C = images.shape
    th, tw = target_size
    scale = min(th / H, tw / W)
    nh, nw = max(1, round(H * scale)), max(1, round(W * scale))
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=True)
    top, left = (th - nh) // 2, (tw - nw) // 2
    x = F.pad(x, (left, tw - nw - left, top, th - nh - top), value=float(fill))
    return _normalize(x.permute(0, 2, 3, 1), mean, std)


def normalize_images(images: torch.Tensor, mean, std) -> torch.Tensor:
    """``(B, H, W, C)`` uint8 (or float) canvases -> normalized fp32: the
    device half of the ``device_preprocess`` split."""
    return _normalize(images.float(), mean, std)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B, N, p*p*C)`` in the ViT patch embedding's
    pixel order."""
    B, H, W, C = images.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = images.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, p * p * C)


def preprocess_patchify(
    images: torch.Tensor,
    target_size: Tuple[int, int],
    patch_size: int,
    mean: Sequence[float] = (0.5,),
    std: Sequence[float] = (0.5,),
    fill: int = 255,
) -> torch.Tensor:
    """Raw batch -> normalized patch sequence for the patch embedding."""
    return patchify(resize_pad_normalize(images, target_size, mean, std, fill), patch_size)
