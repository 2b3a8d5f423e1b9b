"""Vision Transformer encoder (counterpart of :mod:`pixparse_tpu.models.vit`).

Token-sequence ViT (no pooling, no head): patch embedding, cls token,
learned position embedding, pre-LN blocks, final norm. Images are NHWC as
in the JAX package. Parameter names follow timm's ``VisionTransformer``
(``patch_embed.proj``, ``blocks.N.attn.qkv`` ...), so a reference ``.pt``
checkpoint's ``image_encoder.trunk.*`` entries load as they are.

The patch embedding is a reshape plus one matmul over patches flattened in
the JAX pixel order ``(p_h, p_w, C)``; its weight is stored as timm's conv
weight ``(D, C, p, p)`` and permuted to that order at use (the same math as
a stride-p convolution).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.models.remat import block_mode, checkpoint_region, mlp_mode
from pixparse_tpu_torch.ops.attention import dot_product_attention
from pixparse_tpu_torch.ops.dense import Linear
from pixparse_tpu_torch.ops.layer_norm import LayerNorm
from pixparse_tpu_torch.parallel.tensor_parallel import copy_to_model


@dataclasses.dataclass(frozen=True)
class ViTCfg:
    img_size: Tuple[int, int] = (576, 448)
    patch_size: int = 16
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    use_cls_token: bool = True
    pre_norm: bool = False  # CLIP-style LN after patch+pos embed
    ln_eps: float = 1e-6
    drop_rate: float = 0.0

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def num_tokens(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTCfg):
        super().__init__()
        p = cfg.patch_size
        self.patch_size = p
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, p, stride=p)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, gh*gw, D)."""
        B, H, W, C = images.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = images.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * C)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))


class Attention(nn.Module):
    """Fused q/k/v self-attention. Under tensor parallelism (``tp``) the
    rank holds q, k and v of its own heads (their count read off the
    weight) and ``proj`` sums the heads' outputs over the ranks."""

    tp = None  # TPGroup (parallel/tensor_parallel.py)

    def __init__(self, cfg: ViTCfg, attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, kv_lens=None) -> torch.Tensor:
        """``kv_lens``: ``(B,)`` leading valid keys per sample (the
        pix2struct encoder's padded patches), or None."""
        B, L, D = x.shape
        Dh = D // self.num_heads
        qkv = self.qkv(copy_to_model(x, self.tp))
        H = qkv.shape[-1] // (3 * Dh)  # this rank's heads
        # q/k/v stay strided views of the fused projection: the flash kernel
        # reads them in place (no head-split copy)
        q, k, v = qkv.view(B, L, 3, H, Dh).unbind(2)
        out = dot_product_attention(q, k, v, impl=self.attn_impl, dtype=x.dtype, kv_lens=kv_lens)
        return self.proj(out.reshape(B, L, H * Dh))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2; under remat ``'mlp'`` the whole MLP is
    checkpointed, under ``'gelu'`` GELU + fc2 (``models/remat.py``). Under
    tensor parallelism (``tp``) fc1 is column- and fc2 row-parallel."""

    remat_mode = False
    tp = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def _tail(self, h):
        return self.fc2(F.gelu(h))  # exact erf GELU, as in JAX

    def _mlp(self, x):
        return self._tail(self.fc1(x))

    def forward(self, x):
        x = copy_to_model(x, self.tp)
        cut = mlp_mode(self.remat_mode)
        if cut == "gelu":
            return checkpoint_region(self._tail, self.fc1(x))
        if cut == "mlp":
            return checkpoint_region(self._mlp, x)
        return self._mlp(x)


class Block(nn.Module):
    """Pre-LN block; checkpointed whole under remat ``'full'``/``'dots'``."""

    remat_mode = False

    def __init__(self, cfg: ViTCfg, attn_impl: str = "xla"):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.attn = Attention(cfg, attn_impl)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.mlp = Mlp(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio))

    def _block(self, x, kv_lens=None):
        x = x + self.attn(self.norm1(x), kv_lens)
        return x + self.mlp(self.norm2(x))

    def forward(self, x, kv_lens=None):
        cut = block_mode(self.remat_mode)
        if cut:
            return checkpoint_region(self._block, x, kv_lens, dots=cut == "dots")
        return self._block(x, kv_lens)


class ViT(nn.Module):
    """Token-sequence ViT encoder. ``attn_impl``: ``'flash'`` (the CUDA
    kernel on CUDA tensors) or ``'xla'`` (plain attention).
    ``compute_dtype``: dtype of the forward pass; ``None`` = the parameters'
    dtype (each parameter is cast at use, so fp32 master weights can run a
    bf16 forward)."""

    def __init__(self, cfg: ViTCfg, attn_impl: str = "xla", compute_dtype=None):
        super().__init__()
        if cfg.drop_rate:
            raise NotImplementedError("ViT dropout (drop_rate > 0) is not ported")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, D))
        if cfg.pre_norm:
            self.norm_pre = LayerNorm(D, cfg.ln_eps)
        self.blocks = nn.ModuleList(Block(cfg, attn_impl) for _ in range(cfg.depth))
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
        """JAX init scheme: xavier-uniform dense kernels, zero biases and cls
        token, normal(0.02) position embedding, unit LayerNorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        # the patch kernel's fan is (p*p*C, D), as the JAX dense kernel's
        w = self.patch_embed.proj.weight
        bound = (6.0 / (w[0].numel() + w.shape[0])) ** 0.5
        w.uniform_(-bound, bound, generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        if self.cfg.use_cls_token:
            nn.init.zeros_(self.cls_token)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, C) float, already normalized -> (B, N, D)."""
        x = self.patch_embed(images.to(self.compute_dtype or self.pos_embed.dtype))
        if self.cfg.use_cls_token:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if self.cfg.pre_norm:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


# timm-name -> architecture + default normalization stats (the JAX package's
# table; the families the configs use plus a test size)
VIT_ARCH_TABLE = {
    "vit_tiny_patch16_224": dict(embed_dim=192, depth=12, num_heads=3, patch_size=16,
                                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "vit_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6, patch_size=16,
                                  mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "vit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12, patch_size=16,
                                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "vit_large_patch14_clip_224": dict(
        embed_dim=1024, depth=24, num_heads=16, patch_size=14, pre_norm=True,
        mean=(0.48145466, 0.4578275, 0.40821073),
        std=(0.26862954, 0.26130258, 0.27577711),
    ),
    # test-size model, not a timm name
    "vit_test_patch16": dict(embed_dim=64, depth=2, num_heads=2, patch_size=16,
                             mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
}


def resolve_vit_cfg(name: str, image_size: Tuple[int, int], in_chans: int):
    """timm-style encoder name (tag suffixes like '.datacompxl' stripped) ->
    ``(ViTCfg, stats)``."""
    base = name.split(".")[0]
    if base not in VIT_ARCH_TABLE:
        raise ValueError(f"unknown image encoder '{name}' (known: {sorted(VIT_ARCH_TABLE)})")
    arch = dict(VIT_ARCH_TABLE[base])
    stats = dict(mean=arch.pop("mean"), std=arch.pop("std"))
    cfg = ViTCfg(img_size=tuple(image_size), in_chans=in_chans, **arch)
    if image_size[0] % cfg.patch_size or image_size[1] % cfg.patch_size:
        raise ValueError(f"image_size {image_size} not divisible by patch {cfg.patch_size}")
    return cfg, stats
