"""Cruller: ViT or Swin image encoder + BART-style causal text decoder
(counterpart of :mod:`pixparse_tpu.models.cruller`).

Module names follow the reference checkpoint layout:
``image_encoder.trunk.*`` (timm ViT / Swin) and ``text_decoder.trunk.*`` (HF
``BartForCausalLM``), so ``state_dict()`` keys are the reference ``.pt``
keys (see :mod:`pixparse_tpu_torch.models.interop`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from pixparse_tpu_torch.models.bart import (
    DECODE_DTYPES,
    BartCausalDecoder,
    BartDecoderCfg,
    KVCache,
    resolve_bart_cfg,
)
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.models.remat import set_remat
from pixparse_tpu_torch.models.swin import Swin, SwinCfg, resolve_swin_cfg
from pixparse_tpu_torch.models.vit import ViT, ViTCfg, resolve_vit_cfg


def resolve_image_encoder_cfg(name: str, image_size, in_chans: int):
    """Encoder name -> ``(cfg, stats)``: the ViT, Swin or pix2struct family
    (for pix2struct, ``image_size`` is ``(max_patches, patch_size)``)."""
    base = name.split(".")[0]
    if base.startswith(("swin", "donut_swin")):
        return resolve_swin_cfg(name, tuple(image_size), in_chans)
    if base.startswith("pix2struct"):
        from pixparse_tpu_torch.models.pix2struct import resolve_pix2struct_cfg

        return resolve_pix2struct_cfg(name, image_size, in_chans)
    return resolve_vit_cfg(name, tuple(image_size), in_chans)


def create_cruller(vit_cfg, bart_cfg, **kwargs) -> "Cruller":
    """The model for an encoder cfg: :class:`~pixparse_tpu_torch.models.
    pix2struct.Pix2StructCruller` for a ``Pix2StructCfg``, else
    :class:`Cruller`; ``kwargs`` go to the constructor."""
    from pixparse_tpu_torch.models.pix2struct import Pix2StructCfg, Pix2StructCruller

    cls = Pix2StructCruller if isinstance(vit_cfg, Pix2StructCfg) else Cruller
    return cls(vit_cfg, bart_cfg, **kwargs)


def resolve_cruller_cfgs(cfg: ModelCfg, vocab_size: Optional[int] = None):
    """ModelCfg (registry JSON) -> ``(ViTCfg | SwinCfg, BartDecoderCfg, img
    stats)``."""
    in_chans = 1 if cfg.image_encoder.image_fmt == "L" else 3
    vit_cfg, stats = resolve_image_encoder_cfg(
        cfg.image_encoder.name, tuple(cfg.image_encoder.image_size), in_chans
    )
    bart_cfg = resolve_bart_cfg(
        cfg.text_decoder.name,
        num_decoder_layers=cfg.text_decoder.num_decoder_layers,
        max_length=cfg.text_decoder.max_length,
        vocab_size=vocab_size,
    )
    return vit_cfg, bart_cfg, stats


class Cruller(nn.Module):
    """Parameters are created in fp32 on the CPU; move the model with
    ``.to(device, dtype)`` (eval keeps the weights in the compute dtype).
    The encoder is a :class:`Swin` for a ``SwinCfg``, else a :class:`ViT`.
    ``attn_impl``: ``'flash'`` runs attention through the kernels
    (flash attention, window attention), ``'xla'`` through the plain
    attention. ``compute_dtype``: dtype of the forward pass when it differs
    from the parameters' (training: fp32 master weights, bf16 forward);
    ``None`` = the parameters' dtype. ``kv_cache_dtype='int8'`` quantizes
    the cross-attention caches, ``lm_head_dtype='int8'`` makes ``generate``
    apply the tied head in int8 (the JAX package's int8 decode mode).
    ``remat``: the train forward's rematerialisation mode (``False``,
    ``True``/``'full'``, ``'dots'``, ``'mlp'``, ``'gelu'``;
    ``models/remat.py``), for the encoder and the decoder alike; settable."""

    def __init__(
        self,
        vit_cfg: Union[ViTCfg, SwinCfg],
        bart_cfg: BartDecoderCfg,
        attn_impl: str = "xla",
        kv_cache_dtype: str = "bf16",
        lm_head_dtype: str = "bf16",
        compute_dtype: Optional[torch.dtype] = None,
        remat=False,
    ):
        super().__init__()
        if lm_head_dtype not in DECODE_DTYPES:
            raise ValueError(f"lm_head_dtype={lm_head_dtype!r} (one of {DECODE_DTYPES})")
        self.vit_cfg = vit_cfg
        self.bart_cfg = bart_cfg
        self.lm_head_dtype = lm_head_dtype
        self.image_encoder = nn.ModuleDict(
            {"trunk": self.make_encoder(vit_cfg, attn_impl, compute_dtype)}
        )
        self.text_decoder = nn.ModuleDict(
            {"trunk": BartCausalDecoder(bart_cfg, attn_impl, kv_cache_dtype, compute_dtype)}
        )
        self.remat = remat

    @staticmethod
    def make_encoder(cfg, attn_impl, compute_dtype):
        encoder_cls = Swin if isinstance(cfg, SwinCfg) else ViT
        return encoder_cls(cfg, attn_impl, compute_dtype)

    @property
    def remat(self):
        return self._remat

    @remat.setter
    def remat(self, mode):
        set_remat(self, mode)
        self._remat = mode

    @property
    def encoder(self) -> Union[ViT, Swin]:
        return self.image_encoder["trunk"]

    @property
    def decoder(self) -> BartCausalDecoder:
        return self.text_decoder["trunk"]

    @property
    def attn_impl(self) -> str:
        return self.encoder.attn_impl

    @attn_impl.setter
    def attn_impl(self, impl: str):
        self.encoder.attn_impl = impl
        self.decoder.attn_impl = impl

    def init_weights(self, generator: torch.Generator) -> "Cruller":
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        return self

    def forward(self, image_input, text_input, attention_mask=None) -> torch.Tensor:
        """Teacher-forced logits ``(B, L, V)`` fp32."""
        return self.decoder(
            text_input, self.encode(image_input), attention_mask=attention_mask,
            encoder_pad_mask=self.encoder_pad_mask(image_input),
        )

    def encode(self, image_input: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) normalized images -> (B, N, D) in the compute dtype."""
        return self.encoder(image_input)

    def encoder_pad_mask(self, image_input) -> Optional[torch.Tensor]:
        """``(B, N)`` True at the encoder's real tokens, real ones first;
        None when every token is real (ViT, Swin)."""
        return None

    def forward_hidden(self, image_input, text_input, attention_mask=None) -> torch.Tensor:
        """Training fast path: the full forward returning the decoder's
        pre-head hidden states ``(B, L, D)`` for the fused tied-head CE
        (:mod:`pixparse_tpu_torch.ops.loss`). Dropout is live when the module
        is in training mode."""
        return self.decoder(
            text_input, self.encode(image_input), attention_mask=attention_mask,
            return_hidden=True, encoder_pad_mask=self.encoder_pad_mask(image_input),
        )

    # methods that run FSDP2's forward hooks of the root, as forward does
    # (parallel/mesh.py::shard_model)
    fsdp_forward_methods = ("forward_hidden_head",)

    def forward_hidden_head(self, image_input, text_input):
        """:meth:`forward_hidden`, the tied table and its vocabulary shard,
        read in one call: under FSDP2 the table is a whole tensor only
        inside the model's forward (its root keeps it whole until the
        backward). The shard is ``(TPGroup, row offset)`` when the table's
        rows are split over the ``model`` axis (the table is then this
        rank's rows), else None."""
        dec = self.decoder
        shard = None if dec.tp is None else (dec.tp, dec.vocab_offset)
        return self.forward_hidden(image_input, text_input), self.tied_embedding, shard

    @property
    def tied_embedding(self) -> torch.Tensor:
        """The ``(V, D)`` token table that doubles as the LM head."""
        return self.decoder.decoder.embed_tokens.weight

    def decode(
        self,
        input_ids: torch.Tensor,
        encoder_output: torch.Tensor,
        cache: Optional[KVCache] = None,
        key_pad_mask: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        mode: str = "decode",
        positions: Optional[torch.Tensor] = None,
        encoder_pad_mask: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        """Cached decode step / prefill; ``mode='train'`` is a cache-free
        teacher-forced decoder pass. ``cache`` is updated in place."""
        return self.decoder(
            input_ids,
            encoder_output,
            attention_mask=attention_mask,
            key_pad_mask=key_pad_mask,
            mode=mode,
            cache=cache,
            return_hidden=return_hidden,
            positions=positions,
            encoder_pad_mask=encoder_pad_mask,
        )
