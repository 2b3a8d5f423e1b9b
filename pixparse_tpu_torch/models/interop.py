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
the relative-position index is a fixed buffer, not a parameter).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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


def load_cruller_state_dict(model, state_dict: Mapping[str, Any]) -> None:
    """Load a reference-layout state dict into a port ``Cruller`` strictly.
    A checkpoint without the tied head gets it from ``embed_tokens``; a
    checkpoint whose vocab differs from the model's raises."""
    sd = normalize_state_dict(state_dict)
    emb_key = DEC_PREFIX + "embed_tokens.weight"
    if emb_key in sd:
        sd.setdefault(LM_HEAD_KEY, sd[emb_key])
        ckpt_vocab = sd[emb_key].shape[0]
        if ckpt_vocab != model.bart_cfg.vocab_size:
            raise ValueError(
                f"checkpoint vocab {ckpt_vocab} != model vocab "
                f"{model.bart_cfg.vocab_size} (tokenizer + special tokens); the "
                "vocab-resize replay is not ported yet (ROADMAP.md Queue 1)"
            )
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


def _vit_from_jax(sd, p, cfg, prefix: str):
    _patch_embed(sd, p["patch_embed"], cfg, prefix)
    if cfg.use_cls_token:
        sd[prefix + "cls_token"] = np.asarray(p["cls_token"])
    sd[prefix + "pos_embed"] = np.asarray(p["pos_embed"])
    if "norm_pre" in p:
        _norm(sd, prefix + "norm_pre", p["norm_pre"])
    for i in range(cfg.depth):
        blk, b = p[f"blocks_{i}"], f"{prefix}blocks.{i}."
        _norm(sd, b + "norm1", blk["norm1"])
        _linear(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _linear(sd, b + "attn.proj", blk["attn"]["proj"])
        _norm(sd, b + "norm2", blk["norm2"])
        _linear(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
    _norm(sd, prefix + "norm", p["norm"])


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
    """The JAX package's Cruller param tree (``{"image_encoder": ...,
    "text_decoder": ...}``, leaves as numpy arrays) -> the port's state dict
    (fp32 CPU tensors), tied head included. A gradient tree has the same
    structure: with ``tied_head=False`` the result is keyed like the port's
    ``named_parameters()`` (the tied table once, under ``embed_tokens``)."""
    sd: Dict[str, np.ndarray] = {}
    encoder_from_jax = _swin_from_jax if isinstance(vit_cfg, SwinCfg) else _vit_from_jax
    encoder_from_jax(sd, params["image_encoder"], vit_cfg, ENC_PREFIX)
    _bart_from_jax(sd, params["text_decoder"], bart_cfg, DEC_PREFIX)
    if tied_head:
        sd[LM_HEAD_KEY] = sd[DEC_PREFIX + "embed_tokens.weight"]
    return {k: _to_tensor(v) for k, v in sd.items()}


def cruller_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's weights under the reference ``.pt`` names, as fp32 CPU
    tensors: what the train app writes as ``checkpoint-{i}.pt`` and what the
    JAX package's ``load_torch_checkpoint`` + ``cruller_params_from_torch``
    read."""
    return {k: v.detach().to("cpu", torch.float32).clone() for k, v in model.state_dict().items()}


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a model-only ``.pt`` checkpoint (a flat name -> tensor dict)."""
    torch.save({k: v.contiguous() for k, v in state_dict.items()}, path)
