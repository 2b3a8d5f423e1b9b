"""Swin Transformer encoder (counterpart of :mod:`pixparse_tpu.models.swin`).

Token-sequence Swin, as Donut feeds its decoder: patch embedding + LN, four
stages of window-attention blocks (every second block on cyclically shifted
windows) with patch merging between stages, and the final feature map
flattened to ``(B, N, out_dim)``. Images are NHWC as in the JAX package.

- Each block pads its feature map to window multiples and slices back
  (timm), clamps the window to the map (``min(window, H, W)``) and does not
  shift when one window covers the map.
- The relative-position bias is a gather of a learned table through a fixed
  index (numpy, as in JAX), head-major ``(H, ww, ww)``.
- The shift masks are fixed per (padded map, window, shift) and are built
  once per device and kept by the :class:`Swin` module.
- ``attn_impl='flash'`` runs :func:`~pixparse_tpu_torch.ops.window_attention
  .window_attention` (the CUDA kernels, forward and backward, on CUDA
  tensors); ``'xla'`` its plain version.
- Training: fp32 master weights cast at use to the compute dtype; each block
  follows the remat mode (``models/remat.py``): its MLP checkpointed under
  ``'mlp'``/``'gelu'``, the whole block under ``'full'``/``'dots'``.

Parameter names follow timm's ``SwinTransformer``
(``patch_embed.proj``/``.norm``, ``layers.S.blocks.B.attn.qkv`` ...,
``layers.S.downsample.reduction``), the names the JAX package's
``swin_params_to_torch`` writes. The qkv Linear's output features are in
``(3, H, Dh)`` order, so q, k and v are column slices of its output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.models.remat import block_mode, checkpoint_region
from pixparse_tpu_torch.models.vit import Mlp, PatchEmbed
from pixparse_tpu_torch.ops.dense import Linear
from pixparse_tpu_torch.ops.layer_norm import LayerNorm
from pixparse_tpu_torch.ops.window_attention import window_attention, window_attention_plain
from pixparse_tpu_torch.parallel.tensor_parallel import copy_to_model


@dataclasses.dataclass(frozen=True)
class SwinCfg:
    img_size: Tuple[int, int] = (2560, 1920)
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 14, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 10
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5
    drop_rate: float = 0.0
    final_norm: bool = True  # timm applies a final LN; HF DonutSwin does not

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def depth(self) -> int:
        """Total block count."""
        return sum(self.depths)

    @property
    def out_dim(self) -> int:
        return self.embed_dim * (2 ** (self.num_stages - 1))

    def stage_resolution(self, stage: int) -> Tuple[int, int]:
        h = self.img_size[0] // self.patch_size // (2 ** stage)
        w = self.img_size[1] // self.patch_size // (2 ** stage)
        return h, w

    @property
    def num_tokens(self) -> int:
        h, w = self.stage_resolution(self.num_stages - 1)
        return h * w


def _rel_pos_index(window: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative bias table (standard
    Swin construction)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, ww, ww)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # (ww, ww)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, ww, ww) additive mask for shifted windows (0 / -1e9)."""
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // window, window, w // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mw[:, None, :] != mw[:, :, None]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ww, C), windows ordered b * nW + w."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _window_reverse(x: torch.Tensor, window: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    """Fused q/k/v window attention with the relative-position bias. Under
    tensor parallelism (``tp``) the rank holds q, k and v of its own heads
    and their columns of the bias table (the head count read off it)."""

    tp = None  # TPGroup (parallel/tensor_parallel.py)

    def __init__(self, dim: int, num_heads: int, window: int, attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads)
        )
        index = torch.from_numpy(_rel_pos_index(window).reshape(-1))
        self.register_buffer("relative_position_index", index, persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (nB, ww, C); mask: (nW, ww, ww) fp32 or None."""
        N = x.shape[1]
        qkv = self.qkv(copy_to_model(x, self.tp))
        C = qkv.shape[-1] // 3  # this rank's heads' channels
        # head-major gather: bias[h, i, j] for (query i, key j)
        table = self.relative_position_bias_table.float().t()
        bias = table[:, self.relative_position_index].reshape(table.shape[0], N, N)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        attend = window_attention if self.attn_impl == "flash" else window_attention_plain
        return self.proj(attend(q, k, v, bias, mask))


class SwinBlock(nn.Module):
    """Window attention + MLP on a (B, H, W, C) map; checkpointed whole under
    remat ``'full'``/``'dots'`` (the shift mask, a constant, is looked up
    outside the checkpointed part)."""

    remat_mode = False

    def __init__(self, cfg: SwinCfg, dim: int, num_heads: int, resolution: Tuple[int, int],
                 shift: int, attn_impl: str, shift_masks: Dict):
        super().__init__()
        self.window = min(cfg.window_size, *resolution)
        self.shift = shift
        self.shift_masks = shift_masks  # owned by the Swin module
        self.norm1 = LayerNorm(dim, cfg.ln_eps)
        self.attn = WindowAttention(dim, num_heads, self.window, attn_impl)
        self.norm2 = LayerNorm(dim, cfg.ln_eps)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))

    def _mask(self, Hp: int, Wp: int, shift: int, device) -> torch.Tensor:
        key = (Hp, Wp, self.window, shift, str(device))
        if key not in self.shift_masks:
            mask = _shift_attn_mask(Hp, Wp, self.window, shift)
            self.shift_masks[key] = torch.from_numpy(mask).to(device)
        return self.shift_masks[key]

    def _geometry(self, H: int, W: int):
        """(shift, pad_h, pad_w) of this block on an H x W map."""
        window = self.window
        if window != min(window, H, W):
            raise ValueError(f"feature map {H}x{W} is smaller than this block's window {window}")
        # timm: no shifting when one window covers the feature map
        shift = self.shift if window < min(H, W) else 0
        # pad the map to window multiples (timm pads per block, slices after)
        return shift, (window - H % window) % window, (window - W % window) % window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        _, H, W, _ = x.shape
        shift, pad_h, pad_w = self._geometry(H, W)
        mask = self._mask(H + pad_h, W + pad_w, shift, x.device) if shift else None
        cut = block_mode(self.remat_mode)
        if cut:
            return checkpoint_region(self._block, x, mask, shift, pad_h, pad_w,
                                     dots=cut == "dots")
        return self._block(x, mask, shift, pad_h, pad_w)

    def _block(self, x: torch.Tensor, mask, shift: int, pad_h: int, pad_w: int) -> torch.Tensor:
        B, H, W, _ = x.shape
        window = self.window
        Hp, Wp = H + pad_h, W + pad_w
        h = self.norm1(x)
        if pad_h or pad_w:
            h = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        h = _window_reverse(self.attn(_window_partition(h, window), mask), window, B, Hp, Wp)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            h = h[:, :H, :W]
        x = x + h
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinCfg, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, cfg.ln_eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H/2, W/2, 2C); timm's concat order."""
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinPatchEmbed(PatchEmbed):
    """The ViT patch embedding (a Linear over ``(p, p, C)``-flattened
    patches, stored as a conv weight) followed by LayerNorm; NHWC out."""

    def __init__(self, cfg: SwinCfg):
        super().__init__(cfg)
        self.norm = LayerNorm(cfg.embed_dim, cfg.ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        p = self.patch_size
        return self.norm(super().forward(images)).reshape(B, H // p, W // p, -1)


class Swin(nn.Module):
    """Token-sequence Swin encoder: (B, H, W, C) image -> (B, N, out_dim).
    ``attn_impl``: ``'flash'`` (the CUDA kernel on CUDA tensors) or
    ``'xla'`` (plain window attention). ``compute_dtype``: dtype of the
    forward pass; ``None`` = the parameters' dtype."""

    def __init__(self, cfg: SwinCfg, attn_impl: str = "xla", compute_dtype=None):
        super().__init__()
        if cfg.drop_rate:  # 0 in every Swin config of the repo
            raise NotImplementedError("Swin dropout (drop_rate > 0) is not ported")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.shift_masks: Dict = {}
        self.patch_embed = SwinPatchEmbed(cfg)
        gh, gw = cfg.img_size[0] // cfg.patch_size, cfg.img_size[1] // cfg.patch_size
        dim = cfg.embed_dim
        stages = []
        for s in range(cfg.num_stages):
            res = (gh // 2 ** s, gw // 2 ** s)
            blocks = [
                SwinBlock(cfg, dim, cfg.num_heads[s], res,
                          0 if b % 2 == 0 else min(cfg.window_size, *res) // 2,
                          attn_impl, self.shift_masks)
                for b in range(cfg.depths[s])
            ]
            down = None
            if s < cfg.num_stages - 1:
                down = PatchMerging(cfg, dim)
                dim *= 2
            stages.append(SwinStage(blocks, down))
        self.layers = nn.ModuleList(stages)
        if cfg.final_norm:
            self.norm = LayerNorm(dim, cfg.ln_eps)

    def _attentions(self):
        return [blk.attn for stage in self.layers for blk in stage.blocks]

    @property
    def attn_impl(self) -> str:
        return self._attentions()[0].attn_impl

    @attn_impl.setter
    def attn_impl(self, impl: str):
        for attn in self._attentions():
            attn.attn_impl = impl

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """JAX init scheme: xavier-uniform dense kernels, zero biases,
        truncated normal(0.02) bias tables, unit LayerNorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
        # the patch kernel's fan is (p*p*C, D), as the JAX dense kernel's
        w = self.patch_embed.proj.weight
        bound = (6.0 / (w[0].numel() + w.shape[0])) ** 0.5
        w.uniform_(-bound, bound, generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, C) float, already normalized -> (B, N, D)."""
        dtype = self.compute_dtype or self.patch_embed.proj.weight.dtype
        x = self.patch_embed(images.to(dtype))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        if self.cfg.final_norm:
            x = self.norm(x)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


# timm-style names -> architecture + normalization stats (the JAX package's table)
SWIN_ARCH_TABLE = {
    "swin_base_patch4_window7_224": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=7, patch_size=4,
        mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
    ),
    "swin_base_patch4_window12_384": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=12, patch_size=4,
        mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
    ),
    # Donut encoder (HF naver-clova-ix/donut-base layout; no final LN)
    "donut_swin_base": dict(
        embed_dim=128, depths=(2, 2, 14, 2), num_heads=(4, 8, 16, 32),
        window_size=10, patch_size=4, final_norm=False,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    ),
    # test-size model
    "swin_test": dict(
        embed_dim=32, depths=(1, 1), num_heads=(2, 4), window_size=4, patch_size=4,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    ),
}


def resolve_swin_cfg(name: str, image_size: Tuple[int, int], in_chans: int):
    """timm-style encoder name -> ``(SwinCfg, stats)``."""
    base = name.split(".")[0]
    if base not in SWIN_ARCH_TABLE:
        raise ValueError(f"unknown swin encoder '{name}' (known: {sorted(SWIN_ARCH_TABLE)})")
    arch = dict(SWIN_ARCH_TABLE[base])
    stats = dict(mean=arch.pop("mean"), std=arch.pop("std"))
    cfg = SwinCfg(img_size=tuple(image_size), in_chans=in_chans, **arch)
    # each stage's feature map must divide its (possibly clamped) window
    p = cfg.patch_size
    if image_size[0] % (p * 2 ** (cfg.num_stages - 1)) or image_size[1] % (
        p * 2 ** (cfg.num_stages - 1)
    ):
        raise ValueError(
            f"image_size {image_size} must be divisible by "
            f"{p * 2 ** (cfg.num_stages - 1)} for {name}"
        )
    return cfg, stats
