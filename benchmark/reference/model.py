"""Plain PyTorch reference of the Cruller models the benchmark runs: a ViT
or Swin image encoder and a BART-style decoder (post-LN BART or pre-LN
mBART) with a tied head, written from the published architectures
(timm ``VisionTransformer`` / ``SwinTransformer``, HF ``BartForCausalLM``
and the Donut mBART decoder). Float32, no kernels, no cache, no batching
tricks: every sequence is run whole, teacher-forced.

Parameter names are the reference checkpoint's (``image_encoder.trunk.*``,
``text_decoder.trunk.*``), so one dict of seeded weights by name serves
this model and the program alike. Sizes come from a configuration file of
``benchmark/configs`` (its ``encoder`` and ``decoder`` groups).

Dropout: :class:`Dropout` draws each site's keep mask with
``bernoulli_`` from one generator, site after site in the forward order
(embedding; then per layer self-attention, cross-attention, the FFN's
activation and its output), so that a caller who seeds the generator as a
train step does gets that step's masks. Masks are drawn for the whole
batch, then sliced to the rows a call runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.numerics import Numerics

NEG = torch.finfo(torch.float32).min


def _linear(i: int, o: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(i, o, bias=bias)


class Dropout:
    """Keep masks of one train step, drawn in the forward's site order for
    the whole batch; ``rows`` selects the rows a chunk runs."""

    def __init__(self, rate: float, act_rate: float, generator: torch.Generator):
        self.rate, self.act_rate = rate, act_rate
        self.generator = generator
        self.masks: List[torch.Tensor] = []

    def draw(self, shape, rate: float) -> None:
        if rate == 0.0:  # the train step draws no mask for a rate of 0
            return
        keep = 1.0 - rate
        m = torch.empty(shape, dtype=torch.bool, device=self.generator.device)
        self.masks.append(m.bernoulli_(keep, generator=self.generator))

    def draw_step(self, B: int, L: int, D: int, F_: int, layers: int) -> None:
        self.draw((B, L, D), self.rate)
        for _ in range(layers):
            self.draw((B, L, D), self.rate)
            self.draw((B, L, D), self.rate)
            self.draw((B, L, F_), self.act_rate)
            self.draw((B, L, D), self.rate)


def _drop(x, masks, rate, rows):
    """Apply the next mask of ``masks`` (an iterator) to ``x``."""
    if masks is None or rate == 0.0:
        return x
    m = next(masks)[rows]
    return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, c_in: int, dim: int, p: int, norm: bool, eps: float):
        super().__init__()
        self.p = p
        self.proj = nn.Conv2d(c_in, dim, p, stride=p)
        if norm:
            self.norm = nn.LayerNorm(dim, eps=eps)

    def run(self, num: Numerics, images):
        """(B, H, W, C) -> (B, gh, gw, D): a stride-p convolution written as
        a product over ``(p, p, C)``-flattened patches."""
        B, H, W, C = images.shape
        p = self.p
        gh, gw = H // p, W // p
        x = images.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh, gw, -1)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        x = num.linear(x, w, self.proj.bias)
        if hasattr(self, "norm"):
            x = self.norm(x)
        return x


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden, dim)

    def run(self, num, x):
        return num.linear(F.gelu(num.linear(x, self.fc1.weight, self.fc1.bias)),
                          self.fc2.weight, self.fc2.bias)


def attend(num: Numerics, q, k, v, bias=None, causal=False):
    """(B, Lq, H, Dh) x (B, Lk, H, Dh) -> (B, Lq, H, Dh); softmax in fp32."""
    s = num.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.arange(lq, device=s.device)[:, None] + (lk - lq) >= torch.arange(
            lk, device=s.device)[None, :]
        s = s.masked_fill(~keep, NEG)
    p = torch.softmax(s, dim=-1)
    return num.einsum("bhqk,bkhd->bqhd", p, v)


class VitAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)

    def run(self, num, x):
        B, L, D = x.shape
        qkv = num.linear(x, self.qkv.weight, self.qkv.bias).view(B, L, 3, self.heads, -1)
        q, k, v = qkv.unbind(2)
        return num.linear(attend(num, q, k, v).reshape(B, L, D), self.proj.weight, self.proj.bias)


class VitBlock(nn.Module):
    def __init__(self, dim, heads, hidden, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = VitAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, hidden)

    def run(self, num, x):
        x = x + self.attn.run(num, self.norm1(x))
        return x + self.mlp.run(num, self.norm2(x))


class ViT(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        D, p = c["embed_dim"], c["patch_size"]
        gh, gw = c["image_size"][0] // p, c["image_size"][1] // p
        self.cls = bool(c.get("cls_token", True))
        self.patch_embed = PatchEmbed(c["in_chans"], D, p, False, c["ln_eps"])
        if self.cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + int(self.cls), D))
        hidden = int(D * c["mlp_ratio"])
        self.blocks = nn.ModuleList(
            VitBlock(D, c["num_heads"], hidden, c["ln_eps"]) for _ in range(c["depth"]))
        self.norm = nn.LayerNorm(D, eps=c["ln_eps"])

    def run(self, num, images):
        x = self.patch_embed.run(num, images).flatten(1, 2)
        if self.cls:
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk.run(num, x)
        return self.norm(x)


def rel_pos_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]


def shift_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """(nW, ww, ww) additive mask of shifted windows: -1e9 between tokens
    that came from different regions of the map."""
    region = np.zeros((h, w), np.int32)
    n = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            region[hs, ws] = n
            n += 1
    r = region.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    return np.where(r[:, None, :] != r[:, :, None], -1e9, 0.0).astype(np.float32)


class SwinAttention(nn.Module):
    def __init__(self, dim, heads, win):
        super().__init__()
        self.heads = heads
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * win - 1) ** 2, heads))
        self.index = torch.from_numpy(rel_pos_index(win).reshape(-1))

    def run(self, num, x, mask):
        """x: (nB, N, C) windows; mask: (nW, N, N) or None."""
        nB, N, C = x.shape
        H = self.heads
        qkv = num.linear(x, self.qkv.weight, self.qkv.bias).view(nB, N, 3, H, C // H)
        q, k, v = qkv.unbind(2)
        bias = self.relative_position_bias_table.t()[:, self.index.to(x.device)].reshape(H, N, N)
        bias = bias[None]
        if mask is not None:
            nW = mask.shape[0]
            bias = (bias.expand(nB // nW, nW, H, N, N) + mask[None, :, None]).reshape(nB, H, N, N)
        o = attend(num, q, k, v, bias)
        return num.linear(o.reshape(nB, N, C), self.proj.weight, self.proj.bias)


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, win, shift, hidden, eps):
        super().__init__()
        self.win, self.shift = win, shift
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = SwinAttention(dim, heads, win)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, hidden)
        self.masks = {}  # (Hp, Wp, device) -> the shift mask, built once

    def run(self, num, x):
        B, H, W, C = x.shape
        win = self.win
        shift = self.shift if win < min(H, W) else 0
        ph, pw = (win - H % win) % win, (win - W % win) % win
        Hp, Wp = H + ph, W + pw
        h = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        mask = None
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            key = (Hp, Wp, str(x.device))
            if key not in self.masks:
                self.masks[key] = torch.from_numpy(shift_mask(Hp, Wp, win, shift)).to(x.device)
            mask = self.masks[key]
        windows = h.reshape(B, Hp // win, win, Wp // win, win, C).permute(0, 1, 3, 2, 4, 5)
        o = self.attn.run(num, windows.reshape(-1, win * win, C), mask)
        h = o.reshape(B, Hp // win, Wp // win, win, win, C).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(B, Hp, Wp, C)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp.run(num, self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = _linear(4 * dim, 2 * dim, bias=False)

    def run(self, num, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return num.linear(self.norm(x), self.reduction.weight)


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class Swin(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        p, dim, eps = c["patch_size"], c["embed_dim"], c["ln_eps"]
        self.patch_embed = PatchEmbed(c["in_chans"], dim, p, True, eps)
        gh, gw = c["image_size"][0] // p, c["image_size"][1] // p
        stages = []
        for s, depth in enumerate(c["depths"]):
            res = (gh >> s, gw >> s)
            win = min(c["window_size"], *res)
            blocks = [SwinBlock(dim, c["num_heads"][s], win, 0 if b % 2 == 0 else win // 2,
                                int(dim * c["mlp_ratio"]), eps) for b in range(depth)]
            down = None
            if s < len(c["depths"]) - 1:
                down = PatchMerging(dim, eps)
                dim *= 2
            stages.append(SwinStage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.final_norm = bool(c.get("final_norm", True))
        if self.final_norm:
            self.norm = nn.LayerNorm(dim, eps=eps)

    def run(self, num, images):
        x = self.patch_embed.run(num, images)
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk.run(num, x)
            if stage.downsample is not None:
                x = stage.downsample.run(num, x)
        if self.final_norm:
            x = self.norm(x)
        return x.flatten(1, 2)


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

class Projections(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = _linear(d, d), _linear(d, d)
        self.v_proj, self.out_proj = _linear(d, d), _linear(d, d)

    def run(self, num, x, kv, causal):
        B, L, D = x.shape
        H = self.heads
        q = num.linear(x, self.q_proj.weight, self.q_proj.bias).view(B, L, H, -1)
        k = num.linear(kv, self.k_proj.weight, self.k_proj.bias).view(B, kv.shape[1], H, -1)
        v = num.linear(kv, self.v_proj.weight, self.v_proj.bias).view(B, kv.shape[1], H, -1)
        o = attend(num, q, k, v, causal=causal).reshape(B, L, D)
        return num.linear(o, self.out_proj.weight, self.out_proj.bias)


class DecoderLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, eps = c["d_model"], c["ln_eps"]
        self.pre_norm = bool(c["pre_norm"])
        self.self_attn = Projections(d, c["heads"])
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = Projections(d, c["heads"])
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = _linear(d, c["ffn_dim"])
        self.fc2 = _linear(c["ffn_dim"], d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)
        self.rate, self.act_rate = c["dropout"], c["activation_dropout"]

    def run(self, num, x, enc, masks, rows):
        drop = lambda h: _drop(h, masks, self.rate, rows)  # noqa: E731

        def ffn(h):
            h = F.gelu(num.linear(h, self.fc1.weight, self.fc1.bias))
            h = _drop(h, masks, self.act_rate, rows)
            return drop(num.linear(h, self.fc2.weight, self.fc2.bias))

        sa = lambda h: drop(self.self_attn.run(num, h, h, True))  # noqa: E731
        ca = lambda h: drop(self.encoder_attn.run(num, h, enc, False))  # noqa: E731
        if self.pre_norm:
            x = x + sa(self.self_attn_layer_norm(x))
            x = x + ca(self.encoder_attn_layer_norm(x))
            return x + ffn(self.final_layer_norm(x))
        x = self.self_attn_layer_norm(x + sa(x))
        x = self.encoder_attn_layer_norm(x + ca(x))
        return self.final_layer_norm(x + ffn(x))


class DecoderStack(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, eps = c["d_model"], c["ln_eps"]
        self.embed_tokens = nn.Embedding(c["vocab_size"], d)
        self.embed_positions = nn.Embedding(c["max_positions"] + c["pos_offset"], d)
        if c["layernorm_embedding"]:
            self.layernorm_embedding = nn.LayerNorm(d, eps=eps)
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c["layers"]))
        if c["final_layer_norm"]:
            self.layer_norm = nn.LayerNorm(d, eps=eps)


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.model = nn.ModuleDict({"decoder": DecoderStack(c)})
        self.lm_head = nn.Linear(c["d_model"], c["vocab_size"], bias=False)
        self.lm_head.weight = self.model["decoder"].embed_tokens.weight  # tied

    def hidden(self, num, ids, enc, positions, masks=None, rows=slice(None)):
        """(B, L) ids at (B, L) positions over (B, Lk, D) encoder rows ->
        (B, L, D) pre-head hidden states."""
        c, dec = self.c, self.model["decoder"]
        x = dec.embed_tokens(ids)
        if c["scale_embedding"]:
            x = x * c["d_model"] ** 0.5
        x = x + dec.embed_positions(positions + c["pos_offset"])
        if c["layernorm_embedding"]:
            x = dec.layernorm_embedding(x)
        x = _drop(x, masks, c["dropout"], rows)
        for layer in dec.layers:
            x = layer.run(num, x, enc, masks, rows)
        if c["final_layer_norm"]:
            x = dec.layer_norm(x)
        return x

    def logits(self, num, hidden):
        return num.einsum("bld,vd->blv", hidden, self.lm_head.weight)


class Cruller(nn.Module):
    """``image_encoder.trunk`` (ViT or Swin) + ``text_decoder.trunk``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        enc = cfg["encoder"]
        trunk = Swin(enc) if enc["kind"] == "swin" else ViT(enc)
        self.image_encoder = nn.ModuleDict({"trunk": trunk})
        self.text_decoder = nn.ModuleDict({"trunk": Decoder(cfg["decoder"])})

    @property
    def encoder(self):
        return self.image_encoder["trunk"]

    @property
    def decoder(self) -> Decoder:
        return self.text_decoder["trunk"]


def build(cfg: Dict, weights: Dict[str, torch.Tensor], device) -> Cruller:
    """The reference model on ``device`` in float32 with ``weights`` (by
    name; every parameter must be given)."""
    with torch.device("meta"):
        model = Cruller(cfg)
    model = model.to_empty(device=device)
    dec = model.decoder
    dec.lm_head.weight = dec.model["decoder"].embed_tokens.weight  # to_empty unties it
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in weights]
    if missing:
        raise KeyError(f"no weights for {missing[:4]} (+{max(0, len(missing) - 4)})")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


def parameter_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every parameter's name and shape (the tied table once)."""
    with torch.device("meta"):
        model = Cruller(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def norm_parameters(cfg: Dict) -> Dict[str, str]:
    """Names of LayerNorm parameters -> 'weight' or 'bias'."""
    with torch.device("meta"):
        model = Cruller(cfg)
    out = {}
    for mname, m in model.named_modules():
        if isinstance(m, nn.LayerNorm):
            out[f"{mname}.weight"] = "weight"
            out[f"{mname}.bias"] = "bias"
    return out


def teacher_forced(model: Cruller, num: Numerics, images, ids, positions=None,
                   enc: Optional[torch.Tensor] = None):
    """Full forward: encoder rows (unless given) and fp32 logits (B, L, V)."""
    if enc is None:
        enc = model.encoder.run(num, images)
    if positions is None:
        positions = torch.arange(ids.shape[1], device=ids.device)[None].expand_as(ids)
    h = model.decoder.hidden(num, ids, enc, positions)
    return enc, model.decoder.logits(num, h)
