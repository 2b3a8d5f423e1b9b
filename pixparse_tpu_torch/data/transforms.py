"""Document image transforms (counterpart of
:mod:`pixparse_tpu.data.transforms`). Only ``legacy`` is ported, whose train
and eval branches are the same deterministic pipeline: a bicubic resize to
``image_size`` and a normalize, giving float32 numpy ``(H, W, C)``; with
``normalize=False`` the resized uint8 ``(H, W, C)`` canvas, the host half of
the ``device_preprocess`` split (``ops/preprocess.py::normalize_images``
finishes it on the device). The augmenting pipelines ``better`` and
``nougat`` raise. PIL is imported only
when an image needs a resize; an array already at ``image_size`` passes
through as it is (PIL's resize to the same size is a copy)."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Antialiased bicubic PIL resize of a uint8 (H, W) or (H, W, C) array
    to (h, w)."""
    if img.shape[:2] == tuple(size):
        return img
    from PIL import Image

    pil = Image.fromarray(img)
    return np.asarray(pil.resize((size[1], size[0]), Image.BICUBIC))


def _as_float_normalized(img: np.ndarray, mean, std) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None]
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (x - mean) / std


class LegacyTransform:
    """PIL image or uint8 array -> normalized float32 (H, W, C), or the
    uint8 (H, W, C) canvas when ``normalize`` is False."""

    def __init__(self, image_size, image_mean, image_std, normalize: bool = True):
        self.image_size = tuple(image_size)
        self.normalize = normalize
        self.mean = image_mean if isinstance(image_mean, (tuple, list)) else (image_mean,)
        self.std = image_std if isinstance(image_std, (tuple, list)) else (image_std,)

    def __call__(self, img) -> np.ndarray:
        x = np.asarray(img)
        if x.ndim == 3 and x.shape[2] == 1:
            x = x[:, :, 0]
        x = _resize(x, self.image_size)
        if not self.normalize:
            return np.array(x[:, :, None] if x.ndim == 2 else x, dtype=np.uint8)  # writable
        return _as_float_normalized(x, self.mean, self.std)


def create_transforms(
    name: str,
    image_size: Tuple[int, int],
    training: bool = False,
    image_mean: Union[float, Sequence[float]] = 0.5,
    image_std: Union[float, Sequence[float]] = 0.5,
    normalize: bool = True,
) -> LegacyTransform:
    if name not in ("legacy", "better", "nougat"):
        raise ValueError(f"unknown transform set {name!r}")
    if name != "legacy":
        raise NotImplementedError(
            f"transforms {name!r}: only the legacy transform is ported "
            "(ROADMAP.md Queue 1)"
        )
    # legacy has no train-time augmentation: `training` selects nothing
    return LegacyTransform(image_size, image_mean, image_std, normalize)
