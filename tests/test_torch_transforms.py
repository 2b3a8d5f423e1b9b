"""The port's document transforms (``pixparse_tpu_torch/data/transforms.py``)
against the JAX package's (``pixparse_tpu/data/transforms.py``): every
primitive op, and the ``better`` / ``nougat`` pipelines in training and
eval, give the same arrays bit for bit from the same seeds (cv2, PIL and the
native library are all present here); the apply rates match the
reference's probabilities; without cv2 a pipeline that can reach a cv2 op
raises instead of skipping it.
"""

import functools
import sys
import threading

import numpy as np
import pytest

from pixparse_tpu.data import transforms as J
from pixparse_tpu_torch.data import transforms as T


def _page(h=120, w=90, seed=0, channels=None):
    """A light page with dark word bars (the ops' real input), 2-D or with
    ``channels``; a fresh copy of a cached array."""
    return _cached_page(h, w, seed, channels).copy()


@functools.lru_cache(maxsize=None)
def _cached_page(h, w, seed, channels):
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 240, np.uint8)
    for y in range(4, h - 6, 9):
        x = 3
        while x < w - 8:
            n = int(rng.randint(3, 20))
            page[y:y + 5, x:min(x + n, w - 3)] = rng.randint(0, 90)
            x += n + int(rng.randint(2, 6))
    page = np.clip(page.astype(int) + rng.randint(-6, 7, page.shape), 0, 255).astype(np.uint8)
    if channels:
        page = np.stack([np.roll(page, k, axis=1) for k in range(channels)], axis=-1)
    return page


def _rng_op(name, *args, **kwargs):
    return lambda mod, x, seed: getattr(mod, name)(x, np.random.RandomState(seed), *args, **kwargs)


OPS = {
    "crop_margin": lambda mod, x, seed: mod.crop_margin(x),
    "align_long_axis": lambda mod, x, seed: mod.align_long_axis(x, (48, 64)),
    "resize_keep_ratio": lambda mod, x, seed: mod.resize_keep_ratio(x, (64, 48)),
    "resize_keep_ratio_jitter": lambda mod, x, seed: mod.resize_keep_ratio(
        x, (64, 48), "bicubic", 1.04, 1.11),
    "resize_keep_ratio_bilinear_up": lambda mod, x, seed: mod.resize_keep_ratio(
        x, (300, 200), "bilinear"),
    "random_pad": lambda mod, x, seed: mod.random_pad(x, (150, 120), np.random.RandomState(seed)),
    "random_pad_centred": lambda mod, x, seed: mod.random_pad(
        x, (130, 100), np.random.RandomState(seed), fill=0, random_placement=False),
    "center_crop_or_pad": lambda mod, x, seed: mod.center_crop_or_pad(x, (100, 120)),
    "bitmap": lambda mod, x, seed: mod.bitmap(x),
    "erosion_square": lambda mod, x, seed: mod.erosion(x, 3),
    "dilation_square": lambda mod, x, seed: mod.dilation(x, 3),
    "erosion_ellipse": lambda mod, x, seed: mod.erosion(x, (2, 3), np.random.RandomState(seed)),
    "dilation_ellipse": lambda mod, x, seed: mod.dilation(x, (2, 4), np.random.RandomState(seed)),
    "tv_affine_shear": lambda mod, x, seed: mod.tv_affine(x, shear=(2.5, -1.5)),
    "tv_affine_rotate_translate": lambda mod, x, seed: mod.tv_affine(
        x, angle=-2.7, translate=(0, 3), fill=200),
    "tv_affine_scale_nearest": lambda mod, x, seed: mod.tv_affine(
        x, angle=30.0, scale=0.8, interpolation=0),
    "shift_scale_rotate": _rng_op("shift_scale_rotate"),
    "grid_distortion": _rng_op("grid_distortion"),
    "elastic": _rng_op("elastic"),
    "elastic_affine_linear": _rng_op("elastic", alpha_affine=1.2, interpolation=1),
    "gaussian_blur": _rng_op("gaussian_blur"),
    "gaussian_blur_sigma0": _rng_op("gaussian_blur", sigma_range=None),
    "color_jitter": _rng_op("color_jitter"),
    "brightness_contrast": _rng_op("brightness_contrast"),
    "jpeg_compression": _rng_op("jpeg_compression"),
    "gaussian_noise": _rng_op("gaussian_noise"),
}


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("op", sorted(OPS))
def test_primitive_op_equals_jax(op, channels):
    fn = OPS[op]
    for seed in range(3):
        x = _page(seed=seed, channels=channels)
        got, want = fn(T, x.copy(), seed), fn(J, x.copy(), seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


PAGES = [(120, 90), (700, 520), (52, 40), (90, 260), (900, 700)]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", ["better", "nougat"])
def test_pipeline_equals_jax(name, training, normalize):
    """Seeded pages of several sizes (most larger than the canvas, so
    ``resize_keep_ratio`` shrinks them; one smaller, one wide) through both
    pipelines, in one stream per seed: the same arrays and op counts."""
    kw = dict(training=training, image_mean=(0.5,), image_std=(0.25,), normalize=normalize)
    for seed in (0, 7):
        got = T.create_transforms(name, (64, 48), seed=seed, **kw)
        want = J.create_transforms(name, (64, 48), seed=seed, **kw)
        for i in range(90):
            h, w = PAGES[i % len(PAGES)]
            x = _page(h, w, seed=i % 30)
            a, b = got(x), want(x)
            assert a.shape == (64, 48, 1) and a.dtype == (np.float32 if normalize else np.uint8)
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"{name} seed {seed} page {i}")
        assert got.op_counts == want.op_counts
        if training:
            assert sum(got.op_counts.values()) > 0


@pytest.mark.parametrize("name", ["legacy", "better", "nougat"])
def test_pipeline_options_equal_jax(name):
    """``interpolation``, ``crop_margin``, ``align_long_axis``, ``fill`` and
    RGB input in the eval branch; a PIL image as input."""
    from PIL import Image

    kw = dict(training=False, image_mean=(0.4, 0.5, 0.6), image_std=(0.2, 0.3, 0.4),
              interpolation="bilinear", crop_margin=True, align_long_axis=True, fill=17)
    got = T.create_transforms(name, (48, 64), **kw)
    want = J.create_transforms(name, (48, 64), **kw)
    for seed, (h, w) in enumerate(PAGES):
        x = _page(h, w, seed=seed, channels=3)
        for img in (x, Image.fromarray(x)):
            np.testing.assert_array_equal(got(img), want(img))


def test_threads_draw_from_salted_seeds_in_the_order_they_ask():
    """Each thread's RNG is ``seed + n``, n counting the threads that asked
    before it: two threads run one after the other give the JAX streams."""
    kw = dict(training=True, image_mean=0.5, image_std=0.5, seed=3)
    outs = {}
    for mod in (T, J):
        tf = mod.create_transforms("nougat", (64, 48), **kw)
        res = []
        for t in range(2):
            th = threading.Thread(target=lambda: res.append([tf(_page(seed=s)) for s in range(20)]))
            th.start()
            th.join()
        outs[mod] = res
    for a, b in zip(outs[T], outs[J]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(*outs[T]))  # two streams


BETTER_PROBS = {
    "bitmap": 0.05, "morph": 0.02, "shear": 0.05, "rotate_translate": 0.05,
    "elastic": 0.05, "color_jitter": 0.05, "blur": 0.05,
}
NOUGAT_PROBS = {
    "bitmap": 0.05, "morph": 0.02, "shear": 0.03, "shift_scale_rotate": 0.03,
    "grid_distortion": 0.04, "elastic": 0.04, "brightness_contrast": 0.03,
    "jpeg": 0.07, "noise": 0.08, "blur": 0.03,
}


@pytest.mark.parametrize("name,probs", [("better", BETTER_PROBS), ("nougat", NOUGAT_PROBS)])
def test_train_aug_apply_rates_match_reference(name, probs):
    """Apply counts over 2500 seeded samples within 4 sigma of the
    reference probabilities (as ``tests/test_transforms_parity.py``)."""
    n = 2500
    tr = T.create_transforms(name, (32, 24), training=True, image_mean=0.5, image_std=0.5,
                             seed=123)
    img = np.random.RandomState(0).randint(0, 255, (40, 30), np.uint8)
    for _ in range(n):
        out = tr(img)
    assert out.shape == (32, 24, 1)
    for op, p in probs.items():
        rate = tr.op_counts[op] / n
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n), f"{name}/{op}: {rate:.4f} vs {p}"
    assert set(tr.op_counts) <= set(probs)


CV2_OPS = ("erosion_square", "dilation_square", "erosion_ellipse", "tv_affine_shear",
           "shift_scale_rotate", "grid_distortion", "elastic", "gaussian_blur", "jpeg_compression")


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.mark.parametrize("name", ["better", "nougat"])
def test_without_cv2_a_training_pipeline_raises_and_eval_runs(no_cv2, name):
    kw = dict(image_mean=0.5, image_std=0.5, seed=0)
    with pytest.raises(ImportError, match="cv2"):
        T.create_transforms(name, (64, 48), training=True, **kw)
    x = _page(700, 520)
    got = T.create_transforms(name, (64, 48), training=False, **kw)(x)
    np.testing.assert_array_equal(
        got, J.create_transforms(name, (64, 48), training=False, **kw)(x))
    for training in (True, False):
        legacy = T.create_transforms("legacy", (64, 48), training=training, **kw)(x)
        assert legacy.shape == (64, 48, 1)


@pytest.mark.parametrize("op", CV2_OPS)
def test_without_cv2_each_cv2_op_raises(no_cv2, op):
    with pytest.raises(ImportError, match="cv2"):
        OPS[op](T, _page(), 0)


def test_unknown_transform_set_raises():
    with pytest.raises(ValueError, match="unknown"):
        T.create_transforms("best", (64, 48))
