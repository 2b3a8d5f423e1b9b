"""Pix2Struct variable-resolution patchification (counterpart of
:mod:`pixparse_tpu.ops.pix2struct`).

Each image is rescaled, aspect preserved, so its patch grid fills a fixed
``max_patches`` budget; every patch carries its (row, col) grid coordinate.
The output has a fixed shape whatever the page: ``(max_patches, p*p*C)``
float patches, int32 rows and cols, and a validity mask, real patches first
and pad rows zero.

- :func:`patchify_variable`: the host (numpy) path the loaders run on each
  page, resized by the native library's bilinear resize
  (:func:`pixparse_tpu_torch.native.resize_bilinear`, within 1 grey level of
  PIL's), or PIL's bilinear filter without the library;
- :func:`patchify_variable_batch`: the device path for a batch of pages of
  one size, resized with ``F.interpolate(mode="bilinear", antialias=True)``,
  which computes what ``jax.image.resize(method="bilinear")`` does (a
  triangle kernel widened when it shrinks).

Grid math follows the published preprocessor: scale = sqrt(max_patches *
(p/h) * (p/w)), grid dims clamped to >= 1, resize to (rows*p, cols*p).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pixparse_tpu_torch.native import resize_bilinear


def variable_grid(h: int, w: int, patch_size: int, max_patches: int) -> Tuple[int, int]:
    """(rows, cols) of the patch grid maximizing area within the budget."""
    scale = math.sqrt(max_patches * (patch_size / h) * (patch_size / w))
    rows = max(min(math.floor(scale * h / patch_size), max_patches), 1)
    cols = max(min(math.floor(scale * w / patch_size), max_patches), 1)
    # floor() can still overshoot the budget jointly; shrink the larger dim
    while rows * cols > max_patches:
        if rows >= cols:
            rows -= 1
        else:
            cols -= 1
    return rows, cols


def patchify_variable(
    image: np.ndarray,  # (H, W, C) or (H, W), uint8 or float
    patch_size: int,
    max_patches: int,
    mean=(0.5,),
    std=(0.5,),
) -> Dict[str, np.ndarray]:
    """Host path: a page of any size -> fixed ``(max_patches, ...)`` arrays.
    A float image whose max is <= 1.5 is read as [0, 1], else as [0, 255]."""
    if image.ndim == 2:
        image = image[:, :, None]
    if image.dtype.kind == "f":
        scale = 255.0 if image.max() <= 1.5 else 1.0
        image = np.clip(image * scale, 0, 255).astype(np.uint8)
    h, w, c = image.shape
    rows, cols = variable_grid(h, w, patch_size, max_patches)
    th, tw = rows * patch_size, cols * patch_size

    image = image.astype(np.uint8)
    resized = resize_bilinear(image, (th, tw))
    if resized is None:  # no native library: PIL's bilinear filter
        from PIL import Image

        pil = Image.fromarray(image[:, :, 0] if c == 1 else image, "L" if c == 1 else "RGB")
        resized = np.asarray(pil.resize((tw, th), Image.BILINEAR))
        if resized.ndim == 2:
            resized = resized[:, :, None]

    x = resized.astype(np.float32) / 255.0
    mean_a = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std_a = np.asarray(std, np.float32).reshape(1, 1, -1)
    x = (x - mean_a) / std_a

    p = patch_size
    n = rows * cols
    patches = x.reshape(rows, p, cols, p, c).transpose(0, 2, 1, 3, 4).reshape(n, p * p * c)
    out_patches = np.zeros((max_patches, p * p * c), np.float32)
    out_patches[:n] = patches
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    out_rows = np.zeros((max_patches,), np.int32)
    out_cols = np.zeros((max_patches,), np.int32)
    out_rows[:n] = rr.reshape(-1)
    out_cols[:n] = cc.reshape(-1)
    mask = np.zeros((max_patches,), bool)
    mask[:n] = True
    return {"patches": out_patches, "rows": out_rows, "cols": out_cols, "mask": mask}


def patchify_variable_batch(
    images: torch.Tensor,  # (B, H, W, C) float, already normalized
    patch_size: int,
    max_patches: int,
) -> Dict[str, torch.Tensor]:
    """Device path for a batch of pages of one size (the grid is the same for
    every page): resize, cut into patches, pad to ``max_patches``."""
    B, H, W, C = images.shape
    rows, cols = variable_grid(H, W, patch_size, max_patches)
    p = patch_size
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(rows * p, cols * p), mode="bilinear",
                      align_corners=False, antialias=True)
    n = rows * cols
    patches = x.reshape(B, C, rows, p, cols, p).permute(0, 2, 4, 3, 5, 1).reshape(B, n, p * p * C)
    pad = max_patches - n
    patches = F.pad(patches, (0, 0, 0, pad))
    idx = torch.arange(max_patches, device=images.device)
    mask = idx < n
    rr = torch.where(mask, idx // cols, 0).to(torch.int32)
    cc = torch.where(mask, idx % cols, 0).to(torch.int32)
    return {
        "patches": patches,
        "rows": rr.expand(B, max_patches),
        "cols": cc.expand(B, max_patches),
        "mask": mask.expand(B, max_patches),
    }
