"""Pretrained backbones from local files (counterpart of
:mod:`pixparse_tpu.models.pretrained`).

The reference starts from published weights: the image encoder from
``timm.create_model(name, pretrained=True)``, the text decoder from
``AutoModelForCausalLM.from_pretrained(name)`` cut to the config's layer
count and position table; the tasks then add their special tokens and
resize the token table. Weights resolve in order:

1. the cfg's ``pretrained_path`` (a ``.pt``/``.pth``/``.bin``,
   ``.safetensors`` or ``.npz`` state dict in timm / HF layout);
2. ``$PIXPARSE_PRETRAINED_DIR/<clean name>.<ext>`` (``facebook/bart-base``
   -> ``facebook_bart-base.pt``);
3. a live ``timm`` / ``transformers`` load, imported only here (the HF one
   reads the local hub cache only: ``local_files_only``).

``pretrained=True`` with nothing resolvable raises ``RuntimeError`` naming
what was tried: it never falls back to random weights.

The loaders return fragments of the port's own state dict
(``image_encoder.trunk.*``, ``text_decoder.trunk.*``): the encoder with its
input channels adapted and its position grid resized
(:mod:`pixparse_tpu_torch.models.interop`), the decoder cut to the config's
layers, its position table fitted and its token table resized after the
import. :func:`load_pretrained` loads them and raises unless each fragment
covers every tensor of its subtree.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from pixparse_tpu_torch.models.interop import (
    DEC_PREFIX,
    ENC_PREFIX,
    LM_HEAD_KEY,
    adapt_patch_weight,
    load_torch_checkpoint,
    normalize_state_dict,
    resize_pos_embed,
    resize_token_embeddings,
)
from pixparse_tpu_torch.models.swin import SwinCfg
from pixparse_tpu_torch.models.vit import ViTCfg

_logger = logging.getLogger(__name__)

STATE_DICT_EXTS = (".pt", ".pth", ".bin", ".safetensors", ".npz")
_NORM_LINEAR = ("weight", "bias")
_VIT_BLOCK = ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2")
_BART_LAYER = tuple(f"{attn}.{proj}" for attn in ("self_attn", "encoder_attn")
                    for proj in ("q_proj", "k_proj", "v_proj", "out_proj")) + (
    "self_attn_layer_norm", "encoder_attn_layer_norm", "fc1", "fc2", "final_layer_norm")


def _clean_name(name: str) -> str:
    """``'facebook/bart-base'`` -> ``'facebook_bart-base'`` (a file name)."""
    return re.sub(r"[/\\:]", "_", name)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from disk (torch ``.pt``/``.pth``/``.bin``,
    ``.safetensors``, ``.npz``) as fp32 CPU tensors."""
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return normalize_state_dict({k: z[k] for k in z.files})
    if p.suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{path}: reading .safetensors needs the safetensors package, which is not "
                "installed; save the state dict as .pt or .npz instead") from e
        return normalize_state_dict(load_file(str(p)))
    return load_torch_checkpoint(str(p))


def _live_state_dict(name: str, kind: str) -> Mapping[str, Any]:
    if kind == "timm":
        import timm

        return timm.create_model(name, pretrained=True, num_classes=0).state_dict()
    import transformers

    return transformers.AutoModelForCausalLM.from_pretrained(name, local_files_only=True).state_dict()


def _resolve_state_dict(name: str, pretrained_path: Optional[str], kind: str) -> Dict[str, torch.Tensor]:
    """The state dict for ``name``, resolved in the module docstring's order;
    ``kind`` ('timm' encoder or 'hf' decoder) picks the live load. Raises
    ``RuntimeError`` listing everything tried."""
    tried = []
    if pretrained_path:
        if Path(pretrained_path).exists():
            _logger.info("loading pretrained %s weights from %s", kind, pretrained_path)
            return load_state_dict_file(pretrained_path)
        tried.append(f"pretrained_path={pretrained_path!r} (not found)")
    env_dir = os.environ.get("PIXPARSE_PRETRAINED_DIR")
    if env_dir:
        for ext in STATE_DICT_EXTS:
            cand = Path(env_dir) / (_clean_name(name) + ext)
            if cand.exists():
                _logger.info("loading pretrained %s weights from %s", kind, cand)
                return load_state_dict_file(str(cand))
        tried.append(f"$PIXPARSE_PRETRAINED_DIR/{_clean_name(name)}.* in {env_dir!r}")
    else:
        tried.append("$PIXPARSE_PRETRAINED_DIR (unset)")
    try:
        return normalize_state_dict(_live_state_dict(name, kind))
    except Exception as e:  # noqa: BLE001 - every failure is reported below
        tried.append(f"live {kind} load ({type(e).__name__}: {e})")
    raise RuntimeError(
        f"pretrained=True for {name!r} but no weights could be resolved. Tried: "
        f"{'; '.join(tried)}. Give the cfg's pretrained_path or set $PIXPARSE_PRETRAINED_DIR "
        "to a directory of local state dicts."
    )


def _fit_rows(table: torch.Tensor, rows: int, init_std: float = 0.02) -> torch.Tensor:
    """A ``(rows, D)`` table: the first rows kept, or ``normal(0, init_std)``
    rows from ``np.random.RandomState(0)`` appended, as the JAX package
    does (a position table when the config's length differs)."""
    if table.shape[0] >= rows:
        return table[:rows]
    extra = np.random.RandomState(0).normal(0.0, init_std, size=(rows - table.shape[0], table.shape[1]))
    return torch.cat([table, torch.from_numpy(extra.astype(np.float32)).to(table.dtype)])


def _copy(out: Dict[str, torch.Tensor], sd: Mapping[str, torch.Tensor], src: str, dst: str,
          names) -> None:
    """``dst + name`` <- ``src + name`` for each name the checkpoint has (a
    missing one is reported by :func:`load_pretrained`)."""
    for name in names:
        if src + name in sd:
            out[dst + name] = sd[src + name]


def _vit_state(sd, cfg: ViTCfg) -> Dict[str, torch.Tensor]:
    out = {ENC_PREFIX + "patch_embed.proj.weight": adapt_patch_weight(
        sd["patch_embed.proj.weight"], cfg.in_chans)}
    _copy(out, sd, "", ENC_PREFIX, ["patch_embed.proj.bias"] + (["cls_token"] if cfg.use_cls_token else []))
    pos = sd["pos_embed"]
    if pos.shape[1] != cfg.num_tokens:
        pos = resize_pos_embed(pos, cfg.grid_size, has_cls=cfg.use_cls_token)
    out[ENC_PREFIX + "pos_embed"] = pos
    names = [f"norm.{t}" for t in _NORM_LINEAR]
    if cfg.pre_norm:
        names += [f"norm_pre.{t}" for t in _NORM_LINEAR]
    names += [f"blocks.{i}.{m}.{t}" for i in range(cfg.depth) for m in _VIT_BLOCK for t in _NORM_LINEAR]
    _copy(out, sd, "", ENC_PREFIX, names)
    return out


def _swin_state(sd, cfg: SwinCfg) -> Dict[str, torch.Tensor]:
    """timm Swin names; the relative-position index and any attention mask
    are fixed buffers of the port's module and are not taken."""
    out = {ENC_PREFIX + "patch_embed.proj.weight": adapt_patch_weight(
        sd["patch_embed.proj.weight"], cfg.in_chans)}
    names = ["patch_embed.proj.bias"] + [f"patch_embed.norm.{t}" for t in _NORM_LINEAR]
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            base = f"layers.{s}.blocks.{b}."
            names += [base + f"{m}.{t}" for m in _VIT_BLOCK for t in _NORM_LINEAR]
            names.append(base + "attn.relative_position_bias_table")
        if s < cfg.num_stages - 1:
            base = f"layers.{s}.downsample."
            names += [base + f"norm.{t}" for t in _NORM_LINEAR] + [base + "reduction.weight"]
    if cfg.final_norm:
        names += [f"norm.{t}" for t in _NORM_LINEAR]
    _copy(out, sd, "", ENC_PREFIX, names)
    return out


def load_pretrained_encoder_state(enc_cfg, resolved_cfg) -> Dict[str, torch.Tensor]:
    """A timm ViT or Swin state dict -> the port's ``image_encoder.trunk.*``
    tensors for ``resolved_cfg`` (``ViTCfg`` or ``SwinCfg``): input channels
    adapted, the ViT's position grid resized."""
    sd = _resolve_state_dict(enc_cfg.name, getattr(enc_cfg, "pretrained_path", None), "timm")
    if isinstance(resolved_cfg, SwinCfg):
        return _swin_state(sd, resolved_cfg)
    if isinstance(resolved_cfg, ViTCfg):
        return _vit_state(sd, resolved_cfg)
    raise NotImplementedError(
        f"pretrained init is not implemented for encoder cfg {type(resolved_cfg).__name__} "
        f"({enc_cfg.name!r})")


def _detect_decoder_prefix(sd: Mapping[str, torch.Tensor]) -> str:
    for prefix in ("model.decoder.", "decoder.", ""):
        if prefix + "embed_tokens.weight" in sd:
            return prefix
    raise RuntimeError(
        "state dict does not look like an HF BART decoder "
        f"(no *embed_tokens.weight among {len(sd)} keys)")


def load_pretrained_decoder_state(dec_cfg, bart_cfg) -> Dict[str, torch.Tensor]:
    """An HF BART / mBART decoder state dict -> the port's
    ``text_decoder.trunk.*`` tensors at ``bart_cfg``: the checkpoint's
    layers beyond ``decoder_layers`` dropped (fewer raise), the position
    table fitted to ``max_position_embeddings + pos_offset`` rows, and the
    token table resized to ``bart_cfg.vocab_size`` after the import (the
    tasks' token replay); the tied head follows the table."""
    sd = _resolve_state_dict(dec_cfg.name, getattr(dec_cfg, "pretrained_path", None), "hf")
    src = _detect_decoder_prefix(sd)
    n_layers = 0
    while f"{src}layers.{n_layers}.self_attn.q_proj.weight" in sd:
        n_layers += 1
    if n_layers < bart_cfg.decoder_layers:
        raise RuntimeError(f"pretrained decoder {dec_cfg.name!r} has {n_layers} layers, "
                           f"the config needs {bart_cfg.decoder_layers}")
    out = {DEC_PREFIX + "embed_tokens.weight": sd[src + "embed_tokens.weight"],
           DEC_PREFIX + "embed_positions.weight": _fit_rows(
               sd[src + "embed_positions.weight"],
               bart_cfg.max_position_embeddings + bart_cfg.pos_offset)}
    names = [f"layers.{i}.{m}.{t}" for i in range(bart_cfg.decoder_layers) for m in _BART_LAYER
             for t in _NORM_LINEAR]
    if bart_cfg.layernorm_embedding:
        names += [f"layernorm_embedding.{t}" for t in _NORM_LINEAR]
    if bart_cfg.add_final_layer_norm:
        names += [f"layer_norm.{t}" for t in _NORM_LINEAR]
    _copy(out, sd, src, DEC_PREFIX, names)
    out = resize_token_embeddings(out, bart_cfg.vocab_size)
    out[LM_HEAD_KEY] = out[DEC_PREFIX + "embed_tokens.weight"]
    return out


def maybe_load_pretrained(model_cfg, resolved_enc_cfg, bart_cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """Honour the ``pretrained`` flags: ``{'image_encoder': ...,
    'text_decoder': ...}`` fragments for the flags that are set (``{}`` when
    neither is). Raises where a flag is set and no weights resolve."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if model_cfg.image_encoder.pretrained:
        out["image_encoder"] = load_pretrained_encoder_state(model_cfg.image_encoder, resolved_enc_cfg)
    if model_cfg.text_decoder.pretrained:
        out["text_decoder"] = load_pretrained_decoder_state(model_cfg.text_decoder, bart_cfg)
    return out


def load_pretrained(model, fragments: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Load :func:`maybe_load_pretrained`'s fragments into a ``Cruller``
    (``strict=False``: the other subtree keeps its weights), raising unless
    each fragment holds every tensor of its subtree, so that no part of a
    backbone stays random unnoticed."""
    names = model.state_dict().keys()
    for subtree, fragment in fragments.items():
        want = [k for k in names if k.startswith(subtree + ".")]
        missing = sorted(set(want) - set(fragment))
        if missing:
            raise RuntimeError(
                f"pretrained {subtree}: the checkpoint lacks {len(missing)} of the "
                f"{len(want)} tensors, e.g. {missing[:4]}")
        unexpected = model.load_state_dict(dict(fragment), strict=False).unexpected_keys
        if unexpected:
            raise RuntimeError(f"pretrained {subtree}: tensors the model does not have: {unexpected[:4]}")
