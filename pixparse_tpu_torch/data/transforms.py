"""Document image transforms and augmentations (counterpart of
:mod:`pixparse_tpu.data.transforms`: the same names, signatures, RNG draw
order and per-thread salted ``RandomState``, so a seeded pipeline gives the
JAX module's arrays bit for bit).

- ``legacy``: a resize to ``image_size`` and a normalize (train and eval
  alike);
- ``better``: the torchvision-style document pipeline (aspect-kept resize
  with scale/aspect jitter, bitmap, morphology, shear, rotate/translate,
  elastic, colour jitter, blur, random pad, centre crop);
- ``nougat``: resize and random pad first, then the albumentations-style
  sequence (adds shift-scale-rotate, grid distortion, JPEG compression,
  noise).

Every pipeline takes a PIL image or a uint8 array and gives float32 numpy
``(H, W, C)`` at ``image_size``, normalized; with ``normalize=False`` the
uint8 ``(H, W, C)`` canvas, the host half of the ``device_preprocess`` split
(``ops/preprocess.py::normalize_images`` finishes it on the device).

Resizes take the native library's PIL-exact resize
(:func:`pixparse_tpu_torch.native.resize_filter`) first, so ``legacy`` runs
without PIL; PIL is imported only where that library is missing or the
filter is not bilinear/bicubic. The geometric and photometric augmentations
need OpenCV (``cv2``), imported inside the op. Without it such an op raises
``ImportError``, and so does building a training ``better`` / ``nougat``
pipeline, which can reach one: the JAX module instead returns the page
unchanged and still counts the op as applied. ``legacy`` and the eval
branches of ``better`` / ``nougat`` need no cv2.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from pixparse_tpu_torch.native import resize_filter


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "this augmentation needs OpenCV (cv2), which is not installed: "
            "use the 'legacy' transforms or an eval pipeline, or install opencv"
        ) from e
    return cv2


# --------------------------------------------------------------------------
# primitive ops on uint8 numpy arrays (H, W) or (H, W, C)
# --------------------------------------------------------------------------

def _resize(img: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
    """Antialiased resize to (h, w): the native resize (bit-exact with PIL)
    for uint8 bilinear / bicubic, else PIL."""
    out = resize_filter(img, size, interpolation)
    if out is not None:
        return out
    if img.shape[:2] == tuple(size):  # PIL's resize to the same size is a copy
        return img.copy()
    from PIL import Image

    flags = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
             "nearest": Image.NEAREST, "lanczos": Image.LANCZOS}
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((size[1], size[0]), flags.get(interpolation, Image.BICUBIC)))


def crop_margin(img: np.ndarray) -> np.ndarray:
    """Crop to the bounding box of 'ink' pixels: below 200/255 of the
    min-max-normalized grayscale (PIL 'L' luma weights for RGB)."""
    if img.ndim == 2:
        gray = img.astype(np.float32)
    else:
        gray = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        ).astype(np.float32)
    gmax, gmin = float(gray.max()), float(gray.min())
    if gmax <= gmin:
        return img
    norm = (gray - gmin) / (gmax - gmin)
    ys, xs = np.nonzero(norm < (200.0 / 255.0))
    if len(ys) == 0:
        return img
    return img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]


def align_long_axis(img: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Rotate 90 degrees clockwise when the image's long axis disagrees with
    the target canvas orientation."""
    th, tw = target_size
    h, w = img.shape[:2]
    if (tw > th and w < h) or (tw < th and w > h):
        img = np.rot90(img, k=3)
    return img


def resize_keep_ratio(
    img: np.ndarray,
    target_size: Tuple[int, int],
    interpolation: str = "bicubic",
    scale: float = 1.0,
    ratio: float = 1.0,
    longest: float = 1.0,
) -> np.ndarray:
    """Aspect-preserving resize, fit by the longest side (``longest=1``),
    jittered by a common ``scale`` and an aspect ``ratio`` that divides the
    height factor and multiplies the width factor. Not clamped to the
    target: train pads, then centre-crops."""
    th, tw = target_size
    h, w = img.shape[:2]
    ratio_h, ratio_w = h / th, w / tw
    fit = max(ratio_h, ratio_w) * longest + min(ratio_h, ratio_w) * (1.0 - longest)
    nh = max(1, round(h * (scale / ratio) / fit))
    nw = max(1, round(w * (scale * ratio) / fit))
    return _resize(img, (nh, nw), interpolation)


def random_pad(
    img: np.ndarray,
    target_size: Tuple[int, int],
    rng: np.random.RandomState,
    fill: int = 255,
    random_placement: bool = True,
) -> np.ndarray:
    """Pad onto a ``fill`` canvas at a random (train) or centred place. Pad
    only: an axis already at or above the target is left as it is."""
    th, tw = target_size
    h, w = img.shape[:2]
    oh, ow = max(th, h), max(tw, w)
    if random_placement:
        top = int(rng.randint(0, oh - h + 1))
        left = int(rng.randint(0, ow - w + 1))
    else:
        top = (oh - h) // 2
        left = (ow - w) // 2
    if (oh, ow) == (h, w):
        return img
    shape = (oh, ow) if img.ndim == 2 else (oh, ow, img.shape[2])
    canvas = np.full(shape, fill, dtype=img.dtype)
    canvas[top:top + h, left:left + w] = img
    return canvas


def _center_crop(img: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    th, tw = target_size
    h, w = img.shape[:2]
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return img[top:top + th, left:left + tw]


def center_crop_or_pad(img: np.ndarray, target_size: Tuple[int, int], fill: int = 255) -> np.ndarray:
    th, tw = target_size
    h, w = img.shape[:2]
    if h > th:
        top = (h - th) // 2
        img = img[top:top + th]
    if w > tw:
        left = (w - tw) // 2
        img = img[:, left:left + tw]
    return random_pad(img, target_size, np.random, fill=fill, random_placement=False)


def bitmap(img: np.ndarray, threshold: int = 200) -> np.ndarray:
    """Pixels below ``threshold`` go to 0; the others keep their value."""
    return np.where(img < threshold, 0, img).astype(np.uint8)


def _morph_kernel(rng: Optional[np.random.RandomState], scale) -> np.ndarray:
    """``better``: a square kernel of ``scale``; ``nougat``: an ellipse with
    per-axis size ``rng.randint(scale[0], scale[1])``."""
    if isinstance(scale, (tuple, list)):
        size = tuple(int(rng.randint(scale[0], scale[1])) for _ in range(2))
        cv2 = _cv2()
        return cv2.getStructuringElement(cv2.MORPH_ELLIPSE, size)
    return np.ones((scale, scale), np.uint8)


def erosion(img: np.ndarray, scale=3, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Min filter (ink grows on dark-on-light pages)."""
    return _cv2().erode(img, _morph_kernel(rng, scale))


def dilation(img: np.ndarray, scale=3, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    return _cv2().dilate(img, _morph_kernel(rng, scale))


def _border_value(img: np.ndarray, fill: int):
    return [fill] * 3 if img.ndim == 3 else fill


def tv_affine(
    img: np.ndarray,
    angle: float = 0.0,
    translate: Tuple[int, int] = (0, 0),
    shear: Tuple[float, float] = (0.0, 0.0),
    scale: float = 1.0,
    fill: int = 255,
    interpolation: int = 2,  # cv2.INTER_CUBIC
) -> np.ndarray:
    """torchvision's ``F.affine``: its inverse-affine matrix applied by
    ``cv2.warpAffine`` with ``WARP_INVERSE_MAP`` (a positive angle turns
    clockwise on screen, a positive translate moves content right/down)."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    cx, cy = w * 0.5, h * 0.5
    tx, ty = translate
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return cv2.warpAffine(
        img,
        np.array(m, np.float64).reshape(2, 3),
        (w, h),
        flags=interpolation | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT,
        borderValue=_border_value(img, fill),
    )


def shift_scale_rotate(
    img: np.ndarray,
    rng: np.random.RandomState,
    shift_x=(0.0, 0.04),
    shift_y=(0.0, 0.03),
    scale_limit=(-0.15, 0.03),
    rotate_limit: float = 2.0,
    fill: int = 255,
    interpolation: int = 2,
) -> np.ndarray:
    """albumentations' ``ShiftScaleRotate``: rotation and scale about the
    centre, then a fractional shift (one-sided ranges, as ``nougat`` draws
    them)."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(*scale_limit)
    dx = rng.uniform(*shift_x)
    dy = rng.uniform(*shift_y)
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    m[0, 2] += dx * w
    m[1, 2] += dy * h
    return cv2.warpAffine(
        img, m, (w, h), flags=interpolation,
        borderMode=cv2.BORDER_CONSTANT, borderValue=_border_value(img, fill),
    )


def grid_distortion(
    img: np.ndarray,
    rng: np.random.RandomState,
    num_steps: int = 5,
    distort_limit: float = 0.05,
    fill: int = 255,
    interpolation: int = 2,
) -> np.ndarray:
    """albumentations' ``GridDistortion``: a random stretch of each cell of a
    ``num_steps`` grid, remapped."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    stepsx = 1 + rng.uniform(-distort_limit, distort_limit, num_steps + 1)
    stepsy = 1 + rng.uniform(-distort_limit, distort_limit, num_steps + 1)

    def _axis_map(size: int, steps: np.ndarray) -> np.ndarray:
        step = size // num_steps
        mapping = np.zeros(size, np.float32)
        prev = 0.0
        for idx in range(num_steps + 1):
            start = idx * step
            end = min(start + step, size)
            if start >= size:
                break
            cur = size if end == size and start + step > size else prev + step * steps[idx]
            mapping[start:end] = np.linspace(prev, cur, end - start)
            prev = cur
        return mapping

    map_x = np.tile(_axis_map(w, stepsx), (h, 1))
    map_y = np.tile(_axis_map(h, stepsy)[:, None], (1, w))
    return cv2.remap(
        img, map_x, map_y, interpolation=interpolation,
        borderMode=cv2.BORDER_CONSTANT, borderValue=_border_value(img, fill),
    )


def elastic(
    img: np.ndarray,
    rng: np.random.RandomState,
    alpha: float = 50.0,
    sigma: float = 12.0,
    alpha_affine: float = 0.0,
    fill: int = 255,
    interpolation: int = 2,
) -> np.ndarray:
    """Elastic distortion: a gaussian-smoothed random displacement field;
    ``alpha_affine`` adds albumentations' 3-point random affine first."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    if alpha_affine > 0:
        center = np.float32([w, h]) // 2
        sq = min(w, h) // 3
        pts1 = np.float32(
            [center + sq, [center[0] + sq, center[1] - sq], center - sq]
        )
        pts2 = pts1 + rng.uniform(-alpha_affine, alpha_affine, pts1.shape).astype(np.float32)
        img = cv2.warpAffine(
            img, cv2.getAffineTransform(pts1, pts2), (w, h),
            borderMode=cv2.BORDER_CONSTANT, borderValue=_border_value(img, fill),
        )
    dx = cv2.GaussianBlur((rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur((rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    x, y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return cv2.remap(
        img, x + dx, y + dy, interpolation=interpolation,
        borderMode=cv2.BORDER_CONSTANT, borderValue=_border_value(img, fill),
    )


def gaussian_blur(
    img: np.ndarray,
    rng: np.random.RandomState,
    sigma_range: Tuple[float, float] = (0.1, 0.5),
    ksize: int = 3,
) -> np.ndarray:
    """``better``: sigma drawn from ``sigma_range``; ``nougat``: sigma 0
    (cv2 derives it from the kernel size)."""
    cv2 = _cv2()
    sigma = rng.uniform(*sigma_range) if sigma_range else 0.0
    return cv2.GaussianBlur(img, (ksize, ksize), sigma)


def color_jitter(
    img: np.ndarray, rng: np.random.RandomState, brightness: float = 0.1, contrast: float = 0.1
) -> np.ndarray:
    """torchvision's ``ColorJitter(brightness, contrast)``: brightness scales,
    contrast blends with the grayscale mean, in a random order."""
    x = img.astype(np.float32)
    ops = []
    if brightness:
        b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda v: v * b)
    if contrast:
        c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(v):
            if v.ndim == 3 and v.shape[2] == 3:
                mean = (0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2]).mean()
            else:
                mean = v.mean()
            return c * v + (1 - c) * mean

        ops.append(_contrast)
    for i in rng.permutation(len(ops)):
        x = ops[i](x)
    return np.clip(x, 0, 255).astype(np.uint8)


def brightness_contrast(
    img: np.ndarray, rng: np.random.RandomState, brightness: float = 0.1, contrast: float = 0.1
) -> np.ndarray:
    """albumentations' ``RandomBrightnessContrast`` (brightness by max):
    ``img * alpha + beta * 255``."""
    alpha = 1.0 + rng.uniform(-contrast, contrast)
    beta = rng.uniform(-brightness, brightness)
    out = img.astype(np.float32) * alpha + beta * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def jpeg_compression(img: np.ndarray, rng: np.random.RandomState, quality_range=(95, 101)) -> np.ndarray:
    """A JPEG round trip at a quality drawn from ``quality_range``."""
    cv2 = _cv2()
    q = int(rng.randint(*quality_range))
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    if not ok:
        return img
    dec = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
    return dec if dec is not None else img


def gaussian_noise(img: np.ndarray, rng: np.random.RandomState, var_limit=(0.0, 20.0)) -> np.ndarray:
    """albumentations' ``GaussNoise``: variance ~ U(var_limit), sigma its root."""
    sigma = float(np.sqrt(rng.uniform(*var_limit)))
    noise = rng.randn(*img.shape) * sigma
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# pipelines
# --------------------------------------------------------------------------

def _as_float_normalized(img: np.ndarray, mean, std) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None]
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (x - mean) / std


class ImagePipeline:
    """A document transform: PIL image or uint8 array -> normalized float32
    ``(H, W, C)``, or the uint8 canvas when ``normalize`` is False.
    ``op_counts`` counts each augmentation's applications over all samples
    and threads."""

    def __init__(
        self,
        name: str,
        image_size: Tuple[int, int],
        training: bool,
        image_mean,
        image_std,
        interpolation: str = "bicubic",
        crop_margin: bool = False,
        align_long_axis: bool = False,
        fill: int = 255,
        seed: Optional[int] = None,
        normalize: bool = True,
    ):
        if training and name != "legacy":
            _cv2()  # every training 'better' / 'nougat' pipeline can reach a cv2 op
        self.name = name
        self.image_size = tuple(image_size)
        self.training = training
        self.normalize = normalize
        self.mean = image_mean if isinstance(image_mean, (tuple, list)) else (image_mean,)
        self.std = image_std if isinstance(image_std, (tuple, list)) else (image_std,)
        self.interpolation = interpolation
        self.crop_margin = crop_margin
        self.align_long_axis = align_long_axis
        self.fill = fill
        self._seed = seed
        self.op_counts = collections.Counter()
        self._tl = threading.local()
        self._salt_lock = threading.Lock()
        self._next_salt = 0

    @property
    def rng(self) -> np.random.RandomState:
        """This thread's RNG (loader workers are threads; a ``RandomState``
        is not thread-safe): ``seed`` plus a per-pipeline counter of the
        threads that asked, in the order they asked."""
        rng = getattr(self._tl, "rng", None)
        if rng is None:
            with self._salt_lock:
                salt = self._next_salt
                self._next_salt += 1
            rng = np.random.RandomState(None if self._seed is None else self._seed + salt)
            self._tl.rng = rng
        return rng

    def __call__(self, img) -> np.ndarray:
        x = np.asarray(img)
        if x.ndim == 3 and x.shape[2] == 1:
            x = x[:, :, 0]  # the native decoder gives (H, W, 1); the ops work 2D
        if self.name == "legacy":
            return self._finish(_resize(x, self.image_size, self.interpolation))
        return self._document_pipeline(x)

    def _finish(self, x: np.ndarray) -> np.ndarray:
        if not self.normalize:
            return np.array(x[:, :, None] if x.ndim == 2 else x, dtype=np.uint8)  # writable
        return _as_float_normalized(x, self.mean, self.std)

    def _apply(self, gate_p: float, rng, name: str, x, fn):
        """Apply ``fn`` with probability ``gate_p`` and count it."""
        if rng.rand() < gate_p:
            self.op_counts[name] += 1
            return fn(x)
        return x

    def _document_pipeline(self, x: np.ndarray) -> np.ndarray:
        rng = self.rng
        if self.crop_margin:
            x = crop_margin(x)
        if self.align_long_axis:
            x = align_long_axis(x, self.image_size)
        if not self.training:
            x = resize_keep_ratio(x, self.image_size, self.interpolation)
            return self._finish(center_crop_or_pad(x, self.image_size, fill=self.fill))
        if self.name == "nougat":
            return self._finish(self._nougat_train(x, rng))
        return self._finish(self._better_train(x, rng))

    def _better_train(self, x: np.ndarray, rng) -> np.ndarray:
        fill = self.fill
        # aspect-kept resize, scale jitter (p .05, 0.85-1.04) and aspect
        # jitter (p .05, 0.9-1.11)
        scale = float(rng.uniform(0.85, 1.04)) if rng.rand() < 0.05 else 1.0
        ratio = float(rng.uniform(0.9, 1.11)) if rng.rand() < 0.05 else 1.0
        x = resize_keep_ratio(x, self.image_size, self.interpolation, scale, ratio)
        x = self._apply(0.05, rng, "bitmap", x, bitmap)
        x = self._apply(
            0.02, rng, "morph", x,
            lambda v: erosion(v, 3) if rng.rand() < 0.5 else dilation(v, 3),
        )
        x = self._apply(
            0.05, rng, "shear", x,
            lambda v: tv_affine(
                v, shear=(rng.uniform(0, 3.0), rng.uniform(-3.0, 0)), fill=fill
            ),
        )
        x = self._apply(
            0.05, rng, "rotate_translate", x,
            lambda v: tv_affine(
                v,
                angle=rng.uniform(-3.0, 3.0),
                translate=(0, int(round(rng.uniform(-0.04, 0.04) * v.shape[0]))),
                fill=fill,
            ),
        )
        x = self._apply(
            0.05, rng, "elastic", x,
            lambda v: elastic(v, rng, alpha=50.0, sigma=12.0, fill=fill),
        )
        x = self._apply(0.05, rng, "color_jitter", x, lambda v: color_jitter(v, rng, 0.1, 0.1))
        x = self._apply(
            0.05, rng, "blur", x, lambda v: gaussian_blur(v, rng, (0.1, 0.5), ksize=3)
        )
        x = random_pad(x, self.image_size, rng, fill=fill, random_placement=True)
        return _center_crop(x, self.image_size)

    def _nougat_train(self, x: np.ndarray, rng) -> np.ndarray:
        fill = self.fill
        x = resize_keep_ratio(x, self.image_size, self.interpolation)
        x = random_pad(x, self.image_size, rng, fill=fill, random_placement=True)
        x = self._apply(0.05, rng, "bitmap", x, bitmap)
        x = self._apply(
            0.02, rng, "morph", x,
            lambda v: erosion(v, (2, 3), rng) if rng.rand() < 0.5 else dilation(v, (2, 3), rng),
        )
        x = self._apply(
            0.03, rng, "shear", x,
            lambda v: tv_affine(
                v, shear=(rng.uniform(0, 3.0), rng.uniform(-3.0, 0)), fill=fill
            ),
        )
        x = self._apply(
            0.03, rng, "shift_scale_rotate", x,
            lambda v: shift_scale_rotate(v, rng, fill=fill),
        )
        x = self._apply(
            0.04, rng, "grid_distortion", x,
            lambda v: grid_distortion(v, rng, fill=fill),
        )
        # a translate of 0-5 px, then the elastic with its affine pre-warp
        x = self._apply(
            0.04, rng, "elastic", x,
            lambda v: elastic(
                tv_affine(
                    v,
                    translate=(int(rng.randint(0, 6)), int(rng.randint(0, 6))),
                    fill=fill,
                ),
                rng, alpha=50.0, sigma=12.0, alpha_affine=1.2, fill=fill,
                interpolation=1,  # INTER_LINEAR, albumentations' elastic default
            ),
        )
        x = self._apply(
            0.03, rng, "brightness_contrast", x,
            lambda v: brightness_contrast(v, rng, 0.1, 0.1),
        )
        x = self._apply(0.07, rng, "jpeg", x, lambda v: jpeg_compression(v, rng))
        x = self._apply(0.08, rng, "noise", x, lambda v: gaussian_noise(v, rng))
        x = self._apply(
            0.03, rng, "blur", x,
            lambda v: gaussian_blur(v, rng, sigma_range=None, ksize=3),
        )
        return x


def create_transforms(
    name: str,
    image_size: Tuple[int, int],
    training: bool = False,
    image_mean: Union[float, Sequence[float]] = 0.5,
    image_std: Union[float, Sequence[float]] = 0.5,
    interpolation: str = "bicubic",
    crop_margin: bool = False,
    align_long_axis: bool = False,
    fill: int = 255,
    seed: Optional[int] = None,
    normalize: bool = True,
) -> ImagePipeline:
    """'legacy' (resize + normalize), 'better' or 'nougat'; a training
    'better' / 'nougat' pipeline raises ``ImportError`` without cv2."""
    if name not in ("legacy", "better", "nougat"):
        raise ValueError(f"unknown transform set {name!r}")
    return ImagePipeline(
        name=name,
        image_size=image_size,
        training=training,
        image_mean=image_mean,
        image_std=image_std,
        interpolation=interpolation,
        crop_margin=crop_margin,
        align_long_axis=align_long_axis,
        fill=fill,
        seed=seed,
        normalize=normalize,
    )
