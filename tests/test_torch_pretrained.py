"""Pretrained backbones from local files and the vocab-resize replay in the
port, against the JAX package's own functions, on the CPU in fp32.

- ``resize_token_embeddings`` (grow, shrink) bit-identical to the JAX
  package's; ``resize_pos_embed`` up (2x2 -> 4x4, 14x14 -> 36x28) and down
  (24x24 -> 14x14) within 1e-6 of ``jax.image.resize`` (the same weights,
  summed in another order), and up equal to ``F.interpolate(bilinear)``
  within 4e-6 (its own rounding of the weights); the patch embedding's
  channel adaptation 3 -> 1 and 1 -> 3 as the JAX package adapts it, 2 -> 3
  raising in both;
- ViT and Swin encoders from ``.pt``, ``.npz`` and ``.safetensors`` files
  and HF BART / mBART decoders (layers cut, positions fitted both ways,
  vocab resized after the import) equal, after ``cruller_state_dict_from_jax``,
  to what ``pixparse_tpu.models.pretrained`` gives (1e-6 where a resize
  sums, else exactly);
- the resolution order, ``_clean_name``, the ``RuntimeError`` naming
  everything tried, and the checks that no subtree stays random;
- ``train_setup`` with both pretrained flags at ``cruller_test``: the same
  weights as the JAX task's ``train_setup``, and the step-1 loss within
  2e-2; the eval task on a checkpoint with a smaller vocabulary: greedy
  tokens identical to the JAX eval task's.

Donor weights are JAX init trees at other shapes (3 input channels, a
smaller grid, more layers, another vocab and position count), redrawn from
a numpy seed and written with the JAX package's timm / HF exporters.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import pretrained as jpre
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models import torch_interop as jti
from pixparse_tpu.models.config import ImageEncoderCfg as JaxEncCfg
from pixparse_tpu.models.config import TextDecoderCfg as JaxDecCfg
from pixparse_tpu_torch.models import interop
from pixparse_tpu_torch.models import pretrained as tpre
from pixparse_tpu_torch.models.config import ImageEncoderCfg, ModelCfg, TextDecoderCfg, get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs

VOCAB = 300
MBART = dict(pre_norm=True, add_final_layer_norm=True, scale_embedding=True)
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5,
          "scale": 0.3, "relative_position_bias_table": 0.5}


def _redraw(params, seed):
    rng = np.random.RandomState(seed)

    def redraw(path, x):
        key = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x, np.float32)
        if key not in SCALES:
            return x
        noise = rng.normal(0.0, SCALES[key], x.shape).astype(np.float32)
        return x + noise if key == "scale" else noise

    return jax.tree_util.tree_map_with_path(redraw, nn.unbox(params))


def _jax_cruller(vit_cfg, bart_cfg, seed):
    init = JaxCruller(vit_cfg, bart_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *vit_cfg.img_size, vit_cfg.in_chans)),
        jnp.zeros((1, 4), jnp.int32))["params"]
    return _redraw(init, seed)


def _cfgs(model_name, vocab=VOCAB, mbart=False):
    """(JAX vit, JAX bart, port vit, port bart) for a registered test model."""
    jv, jb, _ = jax_resolve(jax_model_config(model_name), vocab_size=vocab)
    tv, tb, _ = resolve_cruller_cfgs(get_model_config(model_name), vocab_size=vocab)
    if mbart:
        jb, tb = dataclasses.replace(jb, **MBART), dataclasses.replace(tb, **MBART)
    return jv, jb, tv, tb


def _save(sd, path):
    """A numpy state dict to ``.pt``, ``.npz`` or ``.safetensors``."""
    sd = {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}
    if path.suffix == ".npz":
        np.savez(path, **sd)
    elif path.suffix == ".safetensors":
        from safetensors.numpy import save_file

        save_file(sd, str(path))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _port_view(jax_params, vit_cfg, bart_cfg):
    """The JAX package's param tree under the port's names."""
    return interop.cruller_state_dict_from_jax(jax_params, vit_cfg, bart_cfg)


def _assert_same(got, want, subtree, atol=0.0):
    want = {k: v for k, v in want.items() if k.startswith(subtree + ".")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0, err_msg=k)


# ---------------------------------------------------------------- interop


@pytest.mark.parametrize("new_vocab", [VOCAB + 37, VOCAB - 11, VOCAB])
def test_resize_token_embeddings_bit_identical_to_jax(new_vocab):
    emb = np.random.RandomState(1).randn(VOCAB, 16).astype(np.float32)
    want = jti.resize_token_embeddings({"embed_tokens": {"embedding": emb}}, new_vocab)
    sd = {interop.DEC_PREFIX + "embed_tokens.weight": torch.from_numpy(emb.copy()),
          interop.LM_HEAD_KEY: torch.from_numpy(emb.copy())}
    got = interop.resize_token_embeddings(sd, new_vocab)
    table = got[interop.DEC_PREFIX + "embed_tokens.weight"]
    np.testing.assert_array_equal(table.numpy(), np.asarray(want["embed_tokens"]["embedding"]))
    assert got[interop.LM_HEAD_KEY] is table


@pytest.mark.parametrize("old,new", [((2, 2), (4, 4)), ((14, 14), (36, 28)), ((24, 24), (14, 14))])
def test_resize_pos_embed_matches_jax(old, new):
    """Within 1e-6: the same triangle-kernel weights (antialiased when the
    grid shrinks), summed in another order."""
    pos = np.random.RandomState(sum(old)).randn(1, 1 + old[0] * old[1], 24).astype(np.float32)
    want = jti.resize_pos_embed(pos, new)
    got = interop.resize_pos_embed(torch.from_numpy(pos), new)
    assert got.shape == (1, 1 + new[0] * new[1], 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if new[0] >= old[0] and new[1] >= old[1]:
        # growing: plain bilinear interpolation; 4e-6 on values up to ~4, as
        # F.interpolate rounds its own interpolation weights in fp32
        grid = torch.from_numpy(pos[:, 1:]).reshape(1, *old, 24).permute(0, 3, 1, 2)
        ref = F.interpolate(grid, size=new, mode="bilinear", align_corners=False)
        np.testing.assert_allclose(got[0, 1:].numpy(), ref[0].permute(1, 2, 0).reshape(-1, 24).numpy(),
                                   atol=4e-6, rtol=0)


@pytest.mark.parametrize("c,in_chans", [(3, 1), (1, 3), (3, 3)])
def test_adapt_patch_weight_matches_jax(c, in_chans):
    w = np.random.RandomState(c).randn(32, c, 4, 4).astype(np.float32)
    want = jti._patch_kernel_from_torch(w, in_chans)  # (p * p * C', D), pixel order (p, p, C')
    got = interop.adapt_patch_weight(torch.from_numpy(w), in_chans)
    assert got.shape == (32, in_chans, 4, 4)
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).reshape(-1, 32).numpy(), want, atol=1e-6, rtol=0)


def test_adapt_patch_weight_refuses_other_channel_counts():
    w = np.zeros((8, 2, 4, 4), np.float32)
    with pytest.raises(ValueError, match="2 to 3 channels"):
        interop.adapt_patch_weight(torch.from_numpy(w), 3)
    with pytest.raises(ValueError, match="cannot adapt"):
        jti._patch_kernel_from_torch(w, 3)


def test_checkpoint_vocab_matches_jax():
    from pixparse_tpu.task.cruller_base import _checkpoint_vocab

    sd = {"a.embed_tokens.weight": np.zeros((77, 4), np.float32), "b": np.zeros(3, np.float32)}
    assert interop.checkpoint_vocab({k: torch.from_numpy(v) for k, v in sd.items()}) == 77
    assert _checkpoint_vocab(sd) == 77
    assert interop.checkpoint_vocab({"b": torch.zeros(3)}) is None


# ------------------------------------------------------------ encoders


def _vit_donor(tmp_path, suffix, seed=3):
    """A timm-layout ViT file at 3 channels and a 2x2 grid (32x32 pixels):
    cruller_test's ViT takes 1 channel and a 4x3 grid."""
    jv, jb, tv, tb = _cfgs("cruller_test")
    donor = dataclasses.replace(jv, img_size=(32, 32), in_chans=3)
    enc = _jax_cruller(donor, jb, seed)["image_encoder"]
    sd = jti.vit_params_to_torch(enc, donor)
    return _save(sd, tmp_path / f"vit{suffix}"), sd


def _swin_donor(tmp_path, suffix, seed=4):
    """A timm-layout Swin file at 3 channels, with the fixed buffers timm
    saves (relative_position_index, attn_mask), for cruller_swin_test."""
    jv, jb, tv, tb = _cfgs("cruller_swin_test")
    donor = dataclasses.replace(jv, in_chans=3)
    enc = _jax_cruller(donor, jb, seed)["image_encoder"]
    sd = jti.swin_params_to_torch(enc, donor)
    ww = donor.window_size ** 2
    for s in range(donor.num_stages):
        for b in range(donor.depths[s]):
            base = f"layers.{s}.blocks.{b}.attn."
            sd[base + "relative_position_index"] = np.arange(ww * ww, dtype=np.float32).reshape(ww, ww)
            sd[base + "attn_mask"] = np.zeros((4, ww, ww), np.float32)
    return _save(sd, tmp_path / f"swin{suffix}"), sd


@pytest.mark.parametrize("suffix", [".pt", ".npz", ".safetensors"])
@pytest.mark.parametrize("model_name", ["cruller_test", "cruller_swin_test"])
def test_encoder_from_file_matches_jax(tmp_path, suffix, model_name):
    jv, jb, tv, tb = _cfgs(model_name)
    donor = _vit_donor if model_name == "cruller_test" else _swin_donor
    path, _ = donor(tmp_path, suffix)
    name = "vit_base_patch16_224" if model_name == "cruller_test" else "swin_base_patch4_window12_384"
    want = jpre.load_pretrained_encoder_params(JaxEncCfg(name=name, pretrained=True, pretrained_path=path), jv)
    got = tpre.load_pretrained_encoder_state(
        ImageEncoderCfg(name=name, pretrained=True, pretrained_path=path), tv)
    dec = _jax_cruller(jv, jb, 9)["text_decoder"]
    _assert_same(got, _port_view({"image_encoder": want, "text_decoder": dec}, tv, tb),
                 "image_encoder", atol=1e-6)
    assert not any("relative_position_index" in k or "attn_mask" in k for k in got)


# ------------------------------------------------------------ decoders


def _bart_donor(tmp_path, jb, layers, positions, vocab, seed=5, prefix="model.decoder."):
    """An HF-layout decoder file: ``layers`` layers, ``positions`` position
    rows (offset included), ``vocab`` token rows."""
    donor = dataclasses.replace(jb, decoder_layers=layers, vocab_size=vocab,
                                max_position_embeddings=positions - jb.pos_offset)
    jv, _, _, _ = _cfgs("cruller_test")
    dec = _jax_cruller(jv, donor, seed)["text_decoder"]
    sd = jti.bart_params_to_torch(dec, donor, prefix=prefix)
    return _save(sd, tmp_path / "bart.pt"), sd


@pytest.mark.parametrize("mbart", [False, True])
@pytest.mark.parametrize("layers,positions,vocab", [
    (3, 200, VOCAB - 40),  # layers cut, positions cut, vocab grown
    (2, 60, VOCAB + 25),  # positions grown, vocab cut
])
def test_decoder_from_file_matches_jax(tmp_path, mbart, layers, positions, vocab):
    jv, jb, tv, tb = _cfgs("cruller_test", mbart=mbart)
    path, sd = _bart_donor(tmp_path, jb, layers, positions, vocab)
    want = jpre.load_pretrained_decoder_params(
        JaxDecCfg(name="facebook/bart-base", pretrained=True, pretrained_path=path), jb)
    got = tpre.load_pretrained_decoder_state(
        TextDecoderCfg(name="facebook/bart-base", pretrained=True, pretrained_path=path), tb)
    enc = _jax_cruller(jv, jb, 9)["image_encoder"]
    _assert_same(got, _port_view({"image_encoder": enc, "text_decoder": want}, tv, tb), "text_decoder")
    table = got[interop.DEC_PREFIX + "embed_tokens.weight"]
    assert table.shape[0] == VOCAB and got[interop.LM_HEAD_KEY] is table
    np.testing.assert_array_equal(table[:min(vocab, VOCAB)].numpy(),
                                  sd["model.decoder.embed_tokens.weight"][:min(vocab, VOCAB)])
    assert got[interop.DEC_PREFIX + "embed_positions.weight"].shape[0] == tb.max_position_embeddings + 2


@pytest.mark.parametrize("prefix", ["decoder.", ""])
def test_decoder_prefix_detection_matches_jax(tmp_path, prefix):
    jv, jb, tv, tb = _cfgs("cruller_test")
    path, sd = _bart_donor(tmp_path, jb, 2, 130, VOCAB, prefix=prefix)
    assert tpre._detect_decoder_prefix(sd) == jpre._detect_decoder_prefix(sd) == prefix
    got = tpre.load_pretrained_decoder_state(TextDecoderCfg(pretrained=True, pretrained_path=path), tb)
    np.testing.assert_array_equal(got[interop.DEC_PREFIX + "layers.1.fc2.weight"].numpy(),
                                  sd[prefix + "layers.1.fc2.weight"])


def test_decoder_with_fewer_layers_raises(tmp_path):
    jv, jb, tv, tb = _cfgs("cruller_test")
    path, _ = _bart_donor(tmp_path, jb, 1, 130, VOCAB)
    with pytest.raises(RuntimeError, match="has 1 layers"):
        tpre.load_pretrained_decoder_state(TextDecoderCfg(pretrained=True, pretrained_path=path), tb)


@pytest.mark.parametrize("rows", [5, 12, 20])
def test_fit_rows_matches_jax(rows):
    table = np.random.RandomState(2).randn(12, 8).astype(np.float32)
    np.testing.assert_array_equal(tpre._fit_rows(torch.from_numpy(table), rows).numpy(),
                                  jpre._fit_rows(table, rows))


# ------------------------------------------------------------ resolution


@pytest.mark.parametrize("name", ["facebook/bart-base", "vit_base_patch16_224", r"a\b:c"])
def test_clean_name_matches_jax(name):
    assert tpre._clean_name(name) == jpre._clean_name(name)


def test_resolution_order(tmp_path, monkeypatch):
    """pretrained_path first, then $PIXPARSE_PRETRAINED_DIR/<clean name>.<ext>."""
    jv, jb, tv, tb = _cfgs("cruller_test")
    explicit, _ = _vit_donor(tmp_path, ".pt", seed=11)
    env = tmp_path / "env"
    env.mkdir()
    in_env, in_env_sd = _vit_donor(env, ".npz", seed=12)
    (env / "vit.npz").rename(env / "vit_base_patch16_224.npz")
    monkeypatch.setenv("PIXPARSE_PRETRAINED_DIR", str(env))
    key = interop.ENC_PREFIX + "blocks.0.attn.qkv.weight"
    got = tpre.load_pretrained_encoder_state(ImageEncoderCfg(pretrained=True, pretrained_path=explicit), tv)
    assert not np.array_equal(got[key].numpy(), in_env_sd["blocks.0.attn.qkv.weight"])
    for path in (None, str(tmp_path / "missing.pt")):
        got = tpre.load_pretrained_encoder_state(ImageEncoderCfg(pretrained=True, pretrained_path=path), tv)
        np.testing.assert_array_equal(got[key].numpy(), in_env_sd["blocks.0.attn.qkv.weight"])


def test_nothing_resolves_raises_naming_what_was_tried(tmp_path, monkeypatch):
    """timm is not installed: the live load fails too, and the error lists
    the explicit path, the directory and the live load."""
    jv, jb, tv, tb = _cfgs("cruller_test")
    monkeypatch.setenv("PIXPARSE_PRETRAINED_DIR", str(tmp_path))
    cfg = ImageEncoderCfg(pretrained=True, pretrained_path=str(tmp_path / "nope.pt"))
    with pytest.raises(RuntimeError, match="pretrained=True") as e:
        tpre.load_pretrained_encoder_state(cfg, tv)
    for part in ("pretrained_path=", "$PIXPARSE_PRETRAINED_DIR/vit_base_patch16_224.*", "live timm load"):
        assert part in str(e.value)
    monkeypatch.delenv("PIXPARSE_PRETRAINED_DIR")
    with pytest.raises(RuntimeError, match=r"\$PIXPARSE_PRETRAINED_DIR \(unset\)"):
        tpre.load_pretrained_encoder_state(ImageEncoderCfg(pretrained=True), tv)
    with pytest.raises(RuntimeError, match="pretrained=True"):
        jpre.load_pretrained_encoder_params(JaxEncCfg(pretrained=True), jv)


def test_safetensors_without_the_package_raises_clearly(tmp_path, monkeypatch):
    import sys

    path, _ = _vit_donor(tmp_path, ".safetensors")
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        tpre.load_state_dict_file(path)


def test_flags_off_load_nothing_and_a_partial_backbone_raises(tmp_path):
    jv, jb, tv, tb = _cfgs("cruller_test")
    assert tpre.maybe_load_pretrained(ModelCfg(), tv, tb) == {}
    _, sd = _vit_donor(tmp_path, ".pt")
    del sd["blocks.1.mlp.fc2.bias"]
    path = _save(sd, tmp_path / "partial.pt")
    cfg = ModelCfg(image_encoder=ImageEncoderCfg(pretrained=True, pretrained_path=path))
    fragments = tpre.maybe_load_pretrained(cfg, tv, tb)
    assert set(fragments) == {"image_encoder"}
    with pytest.raises(RuntimeError, match="lacks 1 of the"):
        tpre.load_pretrained(Cruller(tv, tb), fragments)


# ------------------------------------------------------------ the tasks


def _task_files(tmp_path, jv, jb, vocab):
    """Encoder and decoder files for the tasks: 3 channels at a 2x2 grid, a
    3-layer decoder with 200 positions and ``vocab`` tokens."""
    enc, _ = _vit_donor(tmp_path, ".pt", seed=21)
    dec, _ = _bart_donor(tmp_path, jb, 3, 200, vocab, seed=22)
    return enc, dec


def test_train_setup_pretrained_matches_jax(tmp_path):
    from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
    from pixparse_tpu.parallel.mesh import MeshEnv
    from pixparse_tpu.task import TaskCrullerPretrain as JaxTask
    from pixparse_tpu.task import TaskCrullerPretrainCfg as JaxTaskCfg
    from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrain, TaskCrullerPretrainCfg
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    no_dropout = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    jtask = JaxTask(JaxTaskCfg(model_name="cruller_test", tokenizer=JaxTokCfg(name="pixparse_bytelevel"),
                               opt=JaxOptCfg(learning_rate=1e-3)), MeshEnv.initialize(), None)
    ttask = TaskCrullerPretrain(TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"), device="cpu",
        opt=OptimizationCfg(learning_rate=1e-3)), DeviceEnv.initialize("cpu"), None)
    assert jtask.vocab_size == ttask.vocab_size
    jtask.bart_cfg = dataclasses.replace(jtask.bart_cfg, **no_dropout)
    ttask.bart_cfg = dataclasses.replace(ttask.bart_cfg, **no_dropout)
    enc, dec = _task_files(tmp_path, jtask.vit_cfg, jtask.bart_cfg, jtask.vocab_size - 5)
    for task in (jtask, ttask):
        for sub, path in (("image_encoder", enc), ("text_decoder", dec)):
            getattr(task.cfg.model, sub).pretrained = True
            getattr(task.cfg.model, sub).pretrained_path = path
        task.train_setup(num_batches_per_interval=2)
    want = _port_view(jax.tree_util.tree_map(np.asarray, jtask.state.params), ttask.vit_cfg, ttask.bart_cfg)
    got = ttask.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)

    rng = np.random.RandomState(0)
    L = ttask.max_position_embeddings
    batch = {"image": rng.rand(8, 64, 48, 1).astype(np.float32),
             "text": rng.randint(4, 200, (8, L)).astype(np.int64),
             "target": rng.randint(4, 200, (8, L)).astype(np.int64)}
    want_loss = float(jtask.train_step(dict(batch))["loss"])
    got_loss = float(ttask.train_step(dict(batch))["loss"])
    assert np.isfinite(got_loss)
    assert abs(got_loss - want_loss) <= 2e-2 * abs(want_loss)


def test_eval_task_replays_the_vocab_resize_like_jax():
    """A checkpoint saved before the task's tokens were added (5 rows
    short): the eval task resizes its table as the JAX eval task does, and
    both decode the same greedy tokens."""
    from pixparse_tpu.parallel.mesh import MeshEnv
    from pixparse_tpu.task import TaskCrullerEvalOCR as JaxEval
    from pixparse_tpu.task import TaskCrullerEvalOCRCfg as JaxEvalCfg
    from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    jtask = JaxEval(JaxEvalCfg(model_name="cruller_test", tokenizer=JaxTokCfg(name="pixparse_bytelevel")),
                    MeshEnv.initialize(), None)
    ttask = TaskCrullerEvalOCR(TaskCrullerEvalOCRCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"), device="cpu"),
        DeviceEnv.initialize("cpu"))
    small = jtask.vocab_size - 5
    jv, jb = jtask.vit_cfg, dataclasses.replace(jtask.bart_cfg, vocab_size=small)
    sd = jti.cruller_params_to_torch(_jax_cruller(jv, jb, 31), jv, jb)
    ckpt = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    for task in (jtask, ttask):
        task.resume_state_dict = dict(ckpt)
        task.setup()
    assert ttask.model.bart_cfg.vocab_size == jtask.vocab_size
    images = np.random.RandomState(3).randn(2, 64, 48, 1).astype(np.float32)
    prompt = ttask.prompt_ids(ttask.task_start_token, 2)
    np.testing.assert_array_equal(prompt, jtask.prompt_ids(jtask.task_start_token, 2))
    want = jtask.generate_ids(images, prompt, max_length=12)
    got = ttask.generate_ids(images, prompt, max_length=12)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the train CLI


def _shard(path, n=8):
    import io
    import json
    import tarfile

    from PIL import Image

    rng = np.random.RandomState(0)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (80, 60), np.uint8), "L").save(buf, format="PNG")
            anno = json.dumps({"pages": [{"text": [f"hello world {i}"]}]}).encode()
            for name, data in ((f"{i:05d}.png", buf.getvalue()), (f"{i:05d}.json", anno)):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(path)


def _train_cli(shard, out_dir, enc, dec):
    return [
        "--train.task_name", "cruller_pretrain", "--train.experiment", "e",
        "--train.output_dir", out_dir, "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel", "--task.num_intervals", "1",
        "--task.num_warmup_intervals", "0", "--task.opt.learning_rate", "0",
        "--task.dtype", "float32", "--task.device", "cpu",
        "--task.model.image_encoder.pretrained", "true",
        "--task.model.image_encoder.pretrained_path", enc,
        "--task.model.text_decoder.pretrained", "true",
        "--task.model.text_decoder.pretrained_path", dec,
        "--data.train.source", shard, "--data.train.num_samples", "8",
        "--data.train.batch_size", "4", "--data.train.split", "train",
        "--data.train.num_workers", "1",
    ]


def test_train_cli_starts_from_local_backbones(tmp_path, monkeypatch):
    """``app.train --task.model_name cruller_test --task.model.*.pretrained
    true --task.model.*.pretrained_path ...``: the flags survive the
    registry's model config, and at learning rate 0 the interval checkpoint
    holds the adapted file tensors (as the JAX task's ``train_setup`` loads
    them). A path that does not exist, with no directory to fall back on,
    raises."""
    from pixparse_tpu.parallel.mesh import MeshEnv
    from pixparse_tpu.task import TaskCrullerPretrain as JaxTask
    from pixparse_tpu.task import TaskCrullerPretrainCfg as JaxTaskCfg
    from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
    from pixparse_tpu_torch.app.train import main as train_main

    monkeypatch.delenv("PIXPARSE_PRETRAINED_DIR", raising=False)
    jtask = JaxTask(JaxTaskCfg(model_name="cruller_test", tokenizer=JaxTokCfg(name="pixparse_bytelevel")),
                    MeshEnv.initialize(), None)
    enc, dec = _task_files(tmp_path, jtask.vit_cfg, jtask.bart_cfg, jtask.vocab_size - 3)
    for sub, path in (("image_encoder", enc), ("text_decoder", dec)):
        getattr(jtask.cfg.model, sub).pretrained = True
        getattr(jtask.cfg.model, sub).pretrained_path = path
    jtask.train_setup(num_batches_per_interval=2)
    shard = _shard(tmp_path / "shard-00000.tar")
    out_dir = str(tmp_path / "out")
    assert train_main(_train_cli(shard, out_dir, enc, dec)) == 0
    got = torch.load(str(tmp_path / "out" / "e" / "checkpoints" / "e" / "checkpoint-0.pt"), weights_only=True)
    tv, tb, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=jtask.vocab_size)
    want = _port_view(jax.tree_util.tree_map(np.asarray, jtask.state.params), tv, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(RuntimeError, match="not found"):
        train_main(_train_cli(shard, str(tmp_path / "out2"), str(tmp_path / "missing.pt"), dec))


def test_chip_smoke_pretrained_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``pretrained_train`` phase, run on the CPU at
    cruller_test (stand-in files at 3 channels, a 2x2 grid, 3 layers and 400
    tokens): its own checks pass (the loaded weights equal the file tensors
    adapted independently, finite losses)."""
    import importlib.util
    import json
    import os
    import tempfile
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("PIXPARSE_PRETRAINED_DIR", raising=False)
    cs.phase_pretrained_train(torch, model_name="cruller_test", B=2, steps=2, device="cpu",
                              files=dict(in_chans=3, grid=2, layers=3, vocab=400, positions=130))
    rec = json.loads((tmp_path / "out" / "phases.jsonl").read_text().splitlines()[-1])
    assert rec["loaded_equal_adapted_files"] and rec["adapted_to"] == {
        "in_chans": 1, "grid": [4, 3], "decoder_layers": 2, "vocab": 402}
    assert "PIXPARSE_PRETRAINED_DIR" not in os.environ  # restored
