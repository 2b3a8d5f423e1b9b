"""Pix2Struct-style variable-resolution patch encoder and its Cruller
(counterpart of :mod:`pixparse_tpu.models.pix2struct`).

The encoder consumes :mod:`pixparse_tpu_torch.ops.pix2struct`'s output (a
fixed ``max_patches`` budget of normalized patches, their (row, col) grid
coordinates and a validity mask) instead of a fixed canvas:

- a ``Linear`` patch embedding plus learned row and column tables (summed);
- the ViT's pre-LN blocks, each given the per-sample count of real patches
  (``kv_lens``): the flash kernel masks the padding keys itself, the plain
  path lowers the counts to a bias;
- the final LayerNorm, and pad rows zeroed at the output.

:class:`Pix2StructCruller` is a :class:`~pixparse_tpu_torch.models.cruller.Cruller`
whose image input is the dict ``{patches, rows, cols, mask}``; the mask also
reaches the decoder as ``encoder_pad_mask``, whose cross-attention takes it
as the same counts, so in train mode it runs the flash kernel with them,
with no bias.

Parameter names: ``patch_embed``, ``row_embed``, ``col_embed``,
``blocks.N.*`` (the ViT's), ``norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from pixparse_tpu_torch.models.cruller import Cruller
from pixparse_tpu_torch.models.vit import Block, ViTCfg
from pixparse_tpu_torch.ops.attention import mask_lens
from pixparse_tpu_torch.ops.dense import Linear
from pixparse_tpu_torch.ops.layer_norm import LayerNorm


@dataclasses.dataclass(frozen=True)
class Pix2StructCfg:
    max_patches: int = 2048
    patch_size: int = 16
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_rows: int = 128  # row/col position-table sizes
    max_cols: int = 128
    ln_eps: float = 1e-6

    @property
    def num_tokens(self) -> int:
        return self.max_patches

    @property
    def img_size(self) -> Tuple[int, int]:
        # nominal square canvas with the same patch budget (FLOP accounting)
        side = int(self.max_patches ** 0.5) * self.patch_size
        return (side, side)

    def vit_block_cfg(self) -> ViTCfg:
        return ViTCfg(
            img_size=self.img_size, patch_size=self.patch_size, in_chans=self.in_chans,
            embed_dim=self.embed_dim, depth=self.depth, num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio, use_cls_token=False, ln_eps=self.ln_eps,
        )


class Pix2StructEncoder(nn.Module):
    """(patches, rows, cols, mask) -> ``(B, max_patches, D)``.
    ``attn_impl``: ``'flash'`` or ``'xla'`` (plain); ``compute_dtype``: the
    forward's dtype, ``None`` = the parameters'."""

    def __init__(self, cfg: Pix2StructCfg, attn_impl: str = "xla", compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        D = cfg.embed_dim
        self.patch_embed = Linear(cfg.patch_size ** 2 * cfg.in_chans, D)
        self.row_embed = nn.Embedding(cfg.max_rows, D)
        self.col_embed = nn.Embedding(cfg.max_cols, D)
        block_cfg = cfg.vit_block_cfg()
        self.blocks = nn.ModuleList(Block(block_cfg, attn_impl) for _ in range(cfg.depth))
        self.norm = LayerNorm(D, cfg.ln_eps)

    @property
    def attn_impl(self) -> str:
        return self.blocks[0].attn.attn_impl

    @attn_impl.setter
    def attn_impl(self, impl: str):
        for blk in self.blocks:
            blk.attn.attn_impl = impl

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """JAX init scheme: xavier-uniform dense kernels, zero biases,
        normal(0.02) row and column tables, unit LayerNorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, patches, rows, cols, mask=None) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(patches.to(self.compute_dtype or self.patch_embed.weight.dtype))
        x = x + self.row_embed(rows.long().clamp(0, c.max_rows - 1)).to(x.dtype)
        x = x + self.col_embed(cols.long().clamp(0, c.max_cols - 1)).to(x.dtype)
        # the patchifier packs real patches first, so the mask collapses to
        # per-sample lengths
        kv_lens = mask_lens(mask)
        for blk in self.blocks:
            x = blk(x, kv_lens)
        x = self.norm(x)
        if mask is not None:
            # pad tokens zeroed, so cross-attention keys are clean even if a
            # caller drops the mask
            x = x * mask[..., None].to(x.dtype)
        return x


# encoder-name -> architecture table (the JAX package's)
PIX2STRUCT_ARCH_TABLE = {
    # row/col tables sized to max_patches (HF Pix2Struct convention): a
    # 452x4 extreme-aspect grid must not alias rows past a smaller table
    "pix2struct_base": dict(
        max_patches=2048, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        max_rows=2048, max_cols=2048, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    ),
    "pix2struct_test": dict(
        max_patches=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
        max_rows=64, max_cols=64, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    ),
}


def resolve_pix2struct_cfg(name: str, image_size, in_chans: int):
    """Encoder name -> ``(Pix2StructCfg, stats)``. ``image_size`` is read as
    ``(max_patches, patch_size)`` when given (the family has no fixed
    canvas); None keeps the table's."""
    base = name.split(".")[0]
    if base not in PIX2STRUCT_ARCH_TABLE:
        raise ValueError(
            f"unknown pix2struct encoder '{name}' (known: {sorted(PIX2STRUCT_ARCH_TABLE)})"
        )
    arch = dict(PIX2STRUCT_ARCH_TABLE[base])
    stats = dict(mean=arch.pop("mean"), std=arch.pop("std"))
    if image_size:
        arch["max_patches"], arch["patch_size"] = int(image_size[0]), int(image_size[1])
    return Pix2StructCfg(in_chans=in_chans, **arch), stats


class Pix2StructCruller(Cruller):
    """Pix2Struct patch encoder + BART decoder whose cross-attention sees
    the real patches only. ``Cruller``'s method surface; image input is the
    dict ``{patches, rows, cols, mask}``."""

    @staticmethod
    def make_encoder(cfg, attn_impl, compute_dtype):
        return Pix2StructEncoder(cfg, attn_impl, compute_dtype)

    def encode(self, image_input) -> torch.Tensor:
        return self.encoder(
            image_input["patches"], image_input["rows"], image_input["cols"],
            image_input.get("mask"),
        )

    def encoder_pad_mask(self, image_input):
        return image_input.get("mask")
