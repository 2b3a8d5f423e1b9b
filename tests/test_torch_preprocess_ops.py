"""The port's device preprocessing (``ops/preprocess.py``) against the JAX
package's ``pixparse_tpu.ops.preprocess`` on the CPU, on the same seeded
numpy batches (uint8 and float; pages that shrink, grow and fit exactly):

- ``patchify``: bit-equal, and in the ViT patch embedding's pixel order;
- ``resize_pad_normalize`` and ``preprocess_patchify``: within 1e-5
  absolute on normalized values (``F.interpolate(antialias=True)`` against
  ``jax.image.resize``: two resamplers, fp32 sums in another order);
- ``normalize_images``: bit-equal to the host transform's
  ``_as_float_normalized`` (the ``device_preprocess`` split must not move
  the encoder's input), and within 1e-6 of the JAX function (XLA fuses it
  into other roundings).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.ops import preprocess as jax_pre
from pixparse_tpu_torch.data.transforms import _as_float_normalized, create_transforms
from pixparse_tpu_torch.ops import preprocess as pre

GRAY = ((0.5,), (0.5,))
RGB = ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711))
SHAPES = {  # name: (batch shape, canvas, stats)
    "shrink": ((3, 100, 60, 1), (64, 48), GRAY),
    "grow": ((2, 30, 20, 1), (64, 48), GRAY),
    "exact_fit": ((2, 64, 48, 1), (64, 48), GRAY),
    "rgb_wide": ((2, 50, 70, 3), (48, 64), RGB),
}


def _batch(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, shape).astype(np.uint8)
    if dtype == "float32":
        x = np.clip(x + rng.rand(*shape), 0, 255).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_resize_pad_normalize_and_preprocess_patchify_match_jax(name, dtype):
    shape, canvas, (mean, std) = SHAPES[name]
    x = _batch(shape, dtype, sum(shape))
    want = np.asarray(jax_pre.resize_pad_normalize(jnp.asarray(x), canvas, mean, std))
    got = pre.resize_pad_normalize(torch.from_numpy(x), canvas, mean, std).numpy()
    assert got.shape == want.shape == (shape[0], *canvas, shape[3]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(jax_pre.preprocess_patchify(jnp.asarray(x), canvas, 16, mean, std))
    got = pre.preprocess_patchify(torch.from_numpy(x), canvas, 16, mean, std).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize_pad_fills_the_margin():
    x = _batch((4, 100, 60, 1), "uint8", 0)  # 100x60 -> 64x38, centred on 64x48
    out = pre.resize_pad_normalize(torch.from_numpy(x), (64, 48), fill=255).numpy()
    assert (out[:, :, :5] == 1.0).all() and (out[:, :, -5:] == 1.0).all()
    assert out.min() >= -1.0 and out.max() <= 1.0


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_patchify_bit_equal_to_jax_and_the_patch_embedding(dtype):
    x = _batch((2, 64, 48, 3), dtype, 1)
    got = pre.patchify(torch.from_numpy(x), 16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pre.patchify(jnp.asarray(x), 16)))
    ref = x.reshape(2, 4, 16, 3, 16, 3).transpose(0, 1, 3, 2, 4, 5).reshape(2, 12, 768)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stats", [GRAY, RGB], ids=["gray", "rgb"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_normalize_images_bit_equal_to_the_host_transform(stats, dtype):
    mean, std = stats
    x = _batch((3, 64, 48, len(mean)), dtype, 2)
    got = pre.normalize_images(torch.from_numpy(x), mean, std).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.stack([_as_float_normalized(im, mean, std) for im in x]))
    want = np.asarray(jax_pre.normalize_images(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_the_host_half_keeps_the_uint8_canvas():
    """``create_transforms(normalize=False)``: the resized uint8 canvas,
    which ``normalize_images`` turns into the normalized transform's bits."""
    img = np.random.RandomState(3).randint(0, 256, (101, 77), np.uint8)
    canvas = create_transforms("legacy", (64, 48), normalize=False)(img)
    assert canvas.dtype == np.uint8 and canvas.shape == (64, 48, 1)
    host = create_transforms("legacy", (64, 48))(img)
    dev = pre.normalize_images(torch.from_numpy(canvas[None]), (0.5,), (0.5,))[0].numpy()
    np.testing.assert_array_equal(dev, host)
