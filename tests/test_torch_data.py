"""The port's data layer against the JAX package's on the same samples: the
byte-level tokenizer's call form, ``preprocess_ocr_anno`` /
``preprocess_text_anno`` (token ids exact), ``default_collate`` (exact), the
``legacy`` train transform (pixels within 1e-6; it has no randomness), and
the webdataset loader's batches on one shard (exact ids, pixels 1e-6; one
worker and no shuffle buffer, so both sides read the same order).
"""

import io
import json
import tarfile
from functools import partial

import numpy as np
import pytest
from PIL import Image

from pixparse_tpu.data import preprocess as jp
from pixparse_tpu.data import wds as jwds
from pixparse_tpu.data.transforms import create_transforms as jax_create_transforms
from pixparse_tpu.task.common import add_special_tokens as jax_add_special_tokens
from pixparse_tpu.tokenizers.local_bpe import create_bytelevel_tokenizer
from pixparse_tpu_torch.data import preprocess as tp
from pixparse_tpu_torch.data import wds as twds
from pixparse_tpu_torch.data.config import DatasetCfg
from pixparse_tpu_torch.data.loader import create_loader
from pixparse_tpu_torch.data.transforms import create_transforms
from pixparse_tpu_torch.task.common import PRETRAIN_TASK_START, SPECIAL_TOKENS_FROM_PRETRAIN
from pixparse_tpu_torch.task.common import add_special_tokens
from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer

MAXLEN = 48


@pytest.fixture(scope="module")
def tokenizers():
    jt = create_bytelevel_tokenizer()
    jax_add_special_tokens(jt, SPECIAL_TOKENS_FROM_PRETRAIN)
    tt = ByteLevelTokenizer()
    add_special_tokens(tt, SPECIAL_TOKENS_FROM_PRETRAIN)
    return jt, tt


def _kwargs(tok):
    return dict(tokenizer=tok, max_position_embeddings=MAXLEN,
                task_start_token=PRETRAIN_TASK_START, prompt_end_token=PRETRAIN_TASK_START)


@pytest.mark.parametrize("text", ["hello", "", "naïve café <sep/> x" * 5, "a" * 100])
def test_tokenizer_call_form_matches_hf(tokenizers, text):
    jt, tt = tokenizers
    kw = dict(add_special_tokens=False, return_tensors="np", max_length=MAXLEN,
              padding="max_length", truncation=True)
    want, got = jt(text, **kw), tt(text, **kw)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    assert got.input_ids.shape == (1, MAXLEN) and got.input_ids.dtype == np.int64


def test_preprocess_ocr_anno_matches_jax(tokenizers):
    jt, tt = tokenizers
    anno = {"pages": [
        {"text": ["first page", "line two"]}, {"text": []},
        {"text": ["third page has a rather long line " * 4]},
    ]}
    for seed in range(6):
        want, want_info = jp.preprocess_ocr_anno(
            anno, generator=np.random.RandomState(seed), **_kwargs(jt))
        got, got_info = tp.preprocess_ocr_anno(
            anno, generator=np.random.RandomState(seed), **_kwargs(tt))
        np.testing.assert_array_equal(got["text"][0], want["text"][0])
        np.testing.assert_array_equal(got["target"][0], want["target"][0])
        assert got_info == want_info
    # the prompt token and the padding are masked in the target
    assert got["target"][0][0] == -100 and got["text"][0][0] == tt.convert_tokens_to_ids(
        PRETRAIN_TASK_START)
    with pytest.raises(RuntimeError, match="Empty annotation"):
        tp.preprocess_ocr_anno({"pages": []}, **_kwargs(tt))
    # the old [id, {...}] annotation form is corrected
    a, _ = tp.preprocess_ocr_anno([7, {"pages": [{"text": ["x"]}]}], **_kwargs(tt))
    b, _ = jp.preprocess_ocr_anno([7, {"pages": [{"text": ["x"]}]}], **_kwargs(jt))
    np.testing.assert_array_equal(a["text"][0], b["text"][0])


def test_preprocess_text_anno_matches_jax(tokenizers):
    jt, tt = tokenizers
    want = jp.preprocess_text_anno("some words\nmore", **_kwargs(jt))
    got = tp.preprocess_text_anno("some words\nmore", **_kwargs(tt))
    np.testing.assert_array_equal(got["text"][0], want["text"][0])
    np.testing.assert_array_equal(got["target"][0], want["target"][0])


def test_default_collate_matches_jax():
    rng = np.random.RandomState(0)
    samples = [
        (rng.rand(4, 3, 1).astype(np.float32), rng.randint(0, 9, 5), {"a": rng.rand(2)})
        for _ in range(3)
    ]
    want, got = jwds.default_collate(samples), twds.default_collate(samples)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2]["a"], want[2]["a"])
    assert got[0].shape == (3, 4, 3, 1)


@pytest.mark.parametrize("size", [(80, 60), (64, 48)])  # a resize, and none
def test_legacy_train_transform_matches_jax(size):
    rng = np.random.RandomState(1)
    arr = rng.randint(0, 255, size, np.uint8)
    kw = dict(image_size=(64, 48), training=True, image_mean=(0.5,), image_std=(0.5,))
    want = jax_create_transforms("legacy", **kw)
    got = create_transforms("legacy", **kw)
    for img in (arr, Image.fromarray(arr, "L")):
        out = got(img)
        assert out.shape == (64, 48, 1) and out.dtype == np.float32
        np.testing.assert_allclose(out, want(img), atol=1e-6, rtol=0)
    # the augmenting 'better' pipeline builds too and gives JAX's arrays
    better, jax_better = (f("better", seed=5, **kw) for f in (create_transforms, jax_create_transforms))
    for _ in range(20):
        np.testing.assert_array_equal(better(arr), jax_better(arr))
    assert better.op_counts == jax_better.op_counts
    with pytest.raises(ValueError, match="unknown"):
        create_transforms("best", **kw)


def _make_shard(path, n):
    rng = np.random.RandomState(0)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (80, 60), np.uint8), "L").save(buf, format="PNG")
            for ext, data in (("png", buf.getvalue()),
                              ("json", json.dumps({"pages": [{"text": [f"page {i}"]}]}).encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_webdataset_loader_batches_match_jax(tokenizers, tmp_path):
    jt, tt = tokenizers
    path = str(tmp_path / "shard-00000.tar")
    _make_shard(path, 12)
    assert [s["__key__"] for s in twds.iter_tar_samples(path)] == [
        s["__key__"] for s in jwds.iter_tar_samples(path)]
    kw = dict(image_size=(64, 48), training=True, image_mean=(0.5,), image_std=(0.5,))

    def batches(wds_mod, transforms, preprocess, tok):
        decoder = wds_mod.create_doc_anno_pipe(
            transforms("legacy", **kw), partial(preprocess.preprocess_ocr_anno, **_kwargs(tok)))
        bundle = wds_mod.create_wds_loader(
            path, decoder, is_train=True, num_samples=12, workers=1, batch_size=4, seed=3)
        bundle.loader.shuffle_buffer = 0
        bundle.set_interval(1)
        return bundle, list(bundle.loader)

    jb, want = batches(jwds, jax_create_transforms, jp, jt)
    tb, got = batches(twds, create_transforms, tp, tt)
    assert tb.num_batches == jb.num_batches == len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0].shape == (4, 64, 48, 1) and g[1].shape == (4, MAXLEN)
        np.testing.assert_allclose(g[0], w[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_create_loader_formats(tmp_path, monkeypatch):
    path = str(tmp_path / "shard-00000.tar")
    _make_shard(path, 4)
    tok = ByteLevelTokenizer()
    add_special_tokens(tok, SPECIAL_TOKENS_FROM_PRETRAIN)
    cfg = DatasetCfg(source=path, num_samples=4, batch_size=2, split="train", num_workers=1)
    bundle = create_loader(
        cfg, is_train=True,
        image_preprocess=create_transforms("legacy", image_size=(64, 48), training=True),
        anno_preprocess=partial(tp.preprocess_ocr_anno, **_kwargs(tok)), seed=0,
    )
    assert bundle.num_batches == 2 and len(list(bundle.loader)) == 2
    # hf_dataset: the local SinglePageDocVQA branch (tests/test_torch_hf_loader.py
    # covers the loader); an empty directory has no annotation file
    monkeypatch.setenv("PIXPARSE_DOCVQA_DIR", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="train_v1.0.json"):
        create_loader(DatasetCfg(source="SinglePageDocVQA", num_samples=1, batch_size=1,
                                 split="train", format="hf_dataset"), is_train=True)
    with pytest.raises(ValueError, match="unknown dataset format"):
        create_loader(DatasetCfg(source="x", num_samples=1, batch_size=1, split="train",
                                 format="parquet"), is_train=True)


def test_jpeg_decodes_dct_scaled_to_the_transform_size():
    """With a target size a JPEG decodes at the largest 1/2..1/8 scale that
    stays at least that size (the rule of ``native.choose_jpeg_scale``, the
    one definition, equal to the JAX package's); other formats and no target
    decode at full size. The native decoder gives (H, W, C) arrays."""
    from pixparse_tpu.native import choose_jpeg_scale
    from pixparse_tpu_torch import native

    assert twds.choose_jpeg_scale is native.choose_jpeg_scale
    for full in ((400, 300), (401, 299), (64, 48), (2560, 1920)):
        for target in ((90, 70), (120, 70), (50, 40), (320, 240), (17, 900)):
            assert twds.choose_jpeg_scale(*full, *target) == choose_jpeg_scale(*full, *target)
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 255, (400, 300, 3), np.uint8)
    jpeg, png = io.BytesIO(), io.BytesIO()
    Image.fromarray(pixels).save(jpeg, format="JPEG")
    Image.fromarray(pixels).save(png, format="PNG")
    decode = twds.decode_image_bytes
    assert decode(jpeg.getvalue(), "jpg", "L", target_size=(90, 70)).shape == (100, 75, 1)
    assert decode(jpeg.getvalue(), "jpg", "RGB", target_size=(120, 70)).shape == (200, 150, 3)
    assert decode(jpeg.getvalue(), "jpg", "L").shape == (400, 300, 1)
    assert decode(png.getvalue(), "png", "L", target_size=(90, 70)).shape == (400, 300, 1)
    transform = create_transforms("legacy", image_size=(90, 70))
    assert twds._decode_target_size(transform) == (90, 70)
    assert twds._decode_target_size(None) is None
