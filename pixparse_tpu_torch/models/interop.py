"""Weights carried across (counterpart of
:mod:`pixparse_tpu.models.torch_interop`).

The port's parameter names are the reference ``.pt`` names
(``image_encoder.trunk.*`` timm ViT or Swin, ``text_decoder.trunk.model.decoder.*``
HF BART, tied ``text_decoder.trunk.lm_head.weight``), so a reference
checkpoint loads with ``load_state_dict(strict=True)``.
:func:`cruller_state_dict_from_jax` maps the JAX package's flax parameter
tree (as numpy arrays) to that layout: dense kernels ``(in, out)`` are
transposed to ``nn.Linear``'s ``(out, in)``, the patch kernel
``(p*p*C, D)`` (pixel order ``(p_h, p_w, C)``) becomes the conv weight
``(D, C, p, p)``, and LayerNorm ``scale`` becomes ``weight``. Swin
encoders map as the JAX package's ``swin_params_to_torch`` does (timm names;
the relative-position index is a fixed buffer, not a parameter); the
pix2struct encoder's ``patch_embed`` is a dense layer and its row and column
tables are embeddings, its blocks named as the ViT's.

What a checkpoint of another shape needs before it loads, as the JAX
package does it: :func:`resize_token_embeddings` (the vocab-resize replay:
a checkpoint saved before the finetune tokens were added gets new tied-table
rows drawn exactly as the JAX package draws them), :func:`resize_pos_embed`
(a ViT position grid resized as ``jax.image.resize(method="bilinear")``
resizes it, antialiased when it shrinks) and :func:`adapt_patch_weight`
(3 -> 1 input channels by a sum, 1 -> 3 by a repeat over 3).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pixparse_tpu_torch.models.pix2struct import Pix2StructCfg
from pixparse_tpu_torch.models.swin import SwinCfg

ENC_PREFIX = "image_encoder.trunk."
DEC_PREFIX = "text_decoder.trunk.model.decoder."
LM_HEAD_KEY = "text_decoder.trunk.lm_head.weight"


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def normalize_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Unwrap ``{"model": sd}``, strip ``module.`` prefixes, convert every
    value to an fp32 CPU tensor."""
    if "model" in state_dict and isinstance(state_dict["model"], Mapping):
        state_dict = state_dict["model"]
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _to_tensor(v)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a ``.pt`` checkpoint -> normalized state dict."""
    return normalize_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def checkpoint_vocab(state_dict: Mapping[str, Any]) -> Optional[int]:
    """Rows of the checkpoint's token table (any key ending in
    ``embed_tokens.weight``), or ``None`` without one."""
    for k, v in state_dict.items():
        if k.endswith("embed_tokens.weight"):
            return int(v.shape[0])
    return None


def resize_token_embeddings(
    state_dict: Mapping[str, torch.Tensor], new_vocab: int, seed: int = 0, init_std: float = 0.02
) -> Dict[str, torch.Tensor]:
    """The state dict with its tied token table (``DEC_PREFIX +
    embed_tokens.weight``, and the tied head where present) cut or grown to
    ``new_vocab`` rows. Shrinking keeps the first rows; new rows are
    ``normal(0, init_std)`` from ``np.random.RandomState(seed)``, drawn as the
    JAX package draws them, so both give the same bits."""
    key = DEC_PREFIX + "embed_tokens.weight"
    emb = state_dict[key]
    old_vocab, d = emb.shape
    out = dict(state_dict)
    if new_vocab <= old_vocab:
        table = emb if new_vocab == old_vocab else emb[:new_vocab].clone()
    else:
        extra = np.random.RandomState(seed).normal(0.0, init_std, size=(new_vocab - old_vocab, d))
        table = torch.cat([emb, torch.from_numpy(extra.astype(np.float32)).to(emb.dtype)])
    out[key] = table
    if LM_HEAD_KEY in out:
        out[LM_HEAD_KEY] = table
    return out


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """``(n_out, n_in)`` weights of ``jax.image.resize(method="bilinear")``
    along one axis (``scale_and_translate`` with the triangle kernel,
    antialiased: the kernel widens by ``n_in / n_out`` when it shrinks; as
    ``F.interpolate(mode="bilinear", align_corners=False)`` when it grows)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float32)[None, :]).abs() / kernel_scale
    w = (1.0 - dist).clamp_min(0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return w * inside[:, None]


def resize_pos_embed(
    pos: torch.Tensor,  # (1, N_old, D): the cls token's first where has_cls
    new_grid: Tuple[int, int],
    old_grid: Optional[Tuple[int, int]] = None,
    has_cls: bool = True,
) -> torch.Tensor:
    """ViT position embeddings resized on their grid around the cls token:
    bilinear as ``jax.image.resize`` (antialiased when it shrinks), in fp32.
    ``old_grid`` defaults to a square grid."""
    n_prefix = 1 if has_cls else 0
    prefix, grid = pos[:, :n_prefix], pos[:, n_prefix:].float()
    if old_grid is None:
        side = int(round(grid.shape[1] ** 0.5))
        old_grid = (side, side)
    if tuple(old_grid) == tuple(new_grid):
        return pos
    grid = grid.reshape(*old_grid, -1)
    wh, ww = _resize_weights(old_grid[0], new_grid[0]), _resize_weights(old_grid[1], new_grid[1])
    # along the width first, then the height (as JAX's einsum contracts)
    resized = torch.einsum("ph,hqd->pqd", wh, torch.einsum("qw,hwd->hqd", ww, grid))
    return torch.cat([prefix.float(), resized.reshape(1, new_grid[0] * new_grid[1], -1)], dim=1)


def adapt_patch_weight(w: torch.Tensor, in_chans: int) -> torch.Tensor:
    """A ``(D, C, p, p)`` patch-embed conv weight for ``in_chans`` input
    channels: 3 -> 1 by the sum over channels, 1 -> 3 by a repeat over 3
    divided by 3 (timm's ``adapt_input_conv``); other counts raise."""
    c = w.shape[1]
    if c == in_chans:
        return w
    if in_chans == 1:
        return w.sum(dim=1, keepdim=True)
    if c == 1:
        return w.repeat(1, in_chans, 1, 1) / in_chans
    raise ValueError(f"cannot adapt the patch embedding from {c} to {in_chans} channels")


def load_cruller_state_dict(model, state_dict: Mapping[str, Any]) -> None:
    """Load a reference-layout state dict into a port ``Cruller`` strictly.
    A checkpoint whose vocab differs from the model's (saved before the
    finetune tokens were added) gets its tied table resized first
    (:func:`resize_token_embeddings`, as the JAX package's
    ``import_torch_params`` replays it); a checkpoint without the tied head
    gets it from ``embed_tokens``. A model with an untied head
    (``tied_head`` False: the Moonlight decoder) loads the dict as it is."""
    sd = normalize_state_dict(state_dict)
    if not getattr(model, "tied_head", True):
        model.load_state_dict(sd, strict=True)
        return
    ckpt_vocab = checkpoint_vocab(sd)
    if ckpt_vocab is not None:
        sd.pop(LM_HEAD_KEY, None)  # tied: it follows the (resized) table
        if ckpt_vocab != model.bart_cfg.vocab_size:
            sd = resize_token_embeddings(sd, model.bart_cfg.vocab_size)
        sd[LM_HEAD_KEY] = sd[DEC_PREFIX + "embed_tokens.weight"]
    model.load_state_dict(sd, strict=True)


def _linear(sd, name: str, p: Mapping[str, Any]):
    sd[name + ".weight"] = np.asarray(p["kernel"]).T
    sd[name + ".bias"] = np.asarray(p["bias"])


def _norm(sd, name: str, p: Mapping[str, Any]):
    sd[name + ".weight"] = np.asarray(p["scale"])
    sd[name + ".bias"] = np.asarray(p["bias"])


def _patch_embed(sd, p, cfg, prefix: str):
    k = np.asarray(p["kernel"])
    ps = cfg.patch_size
    sd[prefix + "patch_embed.proj.weight"] = (
        k.reshape(ps, ps, cfg.in_chans, k.shape[1]).transpose(3, 2, 0, 1)
    )
    sd[prefix + "patch_embed.proj.bias"] = np.asarray(p["bias"])


def _vit_blocks_from_jax(sd, p, cfg, prefix: str):
    for i in range(cfg.depth):
        blk, b = p[f"blocks_{i}"], f"{prefix}blocks.{i}."
        _norm(sd, b + "norm1", blk["norm1"])
        _linear(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _linear(sd, b + "attn.proj", blk["attn"]["proj"])
        _norm(sd, b + "norm2", blk["norm2"])
        _linear(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
    _norm(sd, prefix + "norm", p["norm"])


def _vit_from_jax(sd, p, cfg, prefix: str):
    _patch_embed(sd, p["patch_embed"], cfg, prefix)
    if cfg.use_cls_token:
        sd[prefix + "cls_token"] = np.asarray(p["cls_token"])
    sd[prefix + "pos_embed"] = np.asarray(p["pos_embed"])
    if "norm_pre" in p:
        _norm(sd, prefix + "norm_pre", p["norm_pre"])
    _vit_blocks_from_jax(sd, p, cfg, prefix)


def _pix2struct_from_jax(sd, p, cfg, prefix: str):
    _linear(sd, prefix + "patch_embed", p["patch_embed"])
    sd[prefix + "row_embed.weight"] = np.asarray(p["row_embed"]["embedding"])
    sd[prefix + "col_embed.weight"] = np.asarray(p["col_embed"]["embedding"])
    _vit_blocks_from_jax(sd, p, cfg, prefix)


def _swin_from_jax(sd, p, cfg, prefix: str):
    _patch_embed(sd, p["patch_embed"], cfg, prefix)
    _norm(sd, prefix + "patch_embed.norm", p["patch_norm"])
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            blk, base = p[f"layers_{s}_blocks_{b}"], f"{prefix}layers.{s}.blocks.{b}."
            _norm(sd, base + "norm1", blk["norm1"])
            _linear(sd, base + "attn.qkv", blk["attn"]["qkv"])
            _linear(sd, base + "attn.proj", blk["attn"]["proj"])
            sd[base + "attn.relative_position_bias_table"] = np.asarray(
                blk["attn"]["relative_position_bias_table"]
            )
            _norm(sd, base + "norm2", blk["norm2"])
            _linear(sd, base + "mlp.fc1", blk["mlp_fc1"])
            _linear(sd, base + "mlp.fc2", blk["mlp_fc2"])
        if s < cfg.num_stages - 1:
            down, base = p[f"layers_{s}_downsample"], f"{prefix}layers.{s}.downsample."
            _norm(sd, base + "norm", down["norm"])
            sd[base + "reduction.weight"] = np.asarray(down["reduction"]["kernel"]).T
    if cfg.final_norm:
        _norm(sd, prefix + "norm", p["norm"])


def _bart_from_jax(sd, p, cfg, prefix: str):
    sd[prefix + "embed_tokens.weight"] = np.asarray(p["embed_tokens"]["embedding"])
    sd[prefix + "embed_positions.weight"] = np.asarray(p["embed_positions"]["embedding"])
    if "layernorm_embedding" in p:
        _norm(sd, prefix + "layernorm_embedding", p["layernorm_embedding"])
    if "final_norm" in p:
        _norm(sd, prefix + "layer_norm", p["final_norm"])
    for i in range(cfg.decoder_layers):
        layer, b = p[f"layers_{i}"], f"{prefix}layers.{i}."
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _linear(sd, f"{b}{attn}.{proj}", layer[attn][proj])
            _norm(sd, f"{b}{attn}_layer_norm", layer[f"{attn}_layer_norm"])
        _linear(sd, b + "fc1", layer["fc1"])
        _linear(sd, b + "fc2", layer["fc2"])
        _norm(sd, b + "final_layer_norm", layer["final_layer_norm"])


def cruller_state_dict_from_jax(
    params: Mapping[str, Any], vit_cfg, bart_cfg, tied_head: bool = True
) -> Dict[str, torch.Tensor]:
    """The JAX package's Cruller or Pix2StructCruller param tree
    (``{"image_encoder": ..., "text_decoder": ...}``, leaves as numpy
    arrays) -> the port's state dict
    (fp32 CPU tensors), tied head included. A gradient tree has the same
    structure: with ``tied_head=False`` the result is keyed like the port's
    ``named_parameters()`` (the tied table once, under ``embed_tokens``)."""
    sd: Dict[str, np.ndarray] = {}
    encoder_from_jax = (
        _swin_from_jax if isinstance(vit_cfg, SwinCfg)
        else _pix2struct_from_jax if isinstance(vit_cfg, Pix2StructCfg) else _vit_from_jax
    )
    encoder_from_jax(sd, params["image_encoder"], vit_cfg, ENC_PREFIX)
    _bart_from_jax(sd, params["text_decoder"], bart_cfg, DEC_PREFIX)
    if tied_head:
        sd[LM_HEAD_KEY] = sd[DEC_PREFIX + "embed_tokens.weight"]
    return {k: _to_tensor(v) for k, v in sd.items()}


def cruller_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's weights under the reference ``.pt`` names, as fp32 CPU
    tensors: what the train app writes as ``checkpoint-{i}.pt`` and what the
    JAX package's ``load_torch_checkpoint`` + ``cruller_params_from_torch``
    read. An FSDP2-sharded or tensor-parallel model's tensors are gathered
    whole first (a collective: every rank of the mesh must call this)."""
    from pixparse_tpu_torch.parallel.mesh import is_sharded
    from pixparse_tpu_torch.parallel.tensor_parallel import gather_whole

    tp, layouts = getattr(model, "tp", None), getattr(model, "tp_layouts", {})
    out = {}
    for k, v in model.state_dict().items():
        v = (v.full_tensor() if is_sharded(v) else v).detach()
        if tp is not None and k in layouts:
            v = gather_whole(v, layouts[k], tp)
        out[k] = v.to("cpu", torch.float32).clone()
    return out


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a model-only ``.pt`` checkpoint (a flat name -> tensor dict)."""
    torch.save({k: v.contiguous() for k, v in state_dict.items()}, path)
