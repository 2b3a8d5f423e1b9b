"""Plain float32 reference of ``cruller_moonlight``: the ViT, the projector
and Moonlight-16B-A3B's decoder (DeepSeek-V3's latent attention and routed
experts) as a prefix LM, and its next-token loss, in plain ``torch`` over a
dict of parameters named as the port's state dict. It imports nothing of
either package: written from the published equations (timm's ViT, HF
``modeling_deepseek.py``), no kernels, no cache, every sequence whole. The
experts run as a loop over experts with masks.

``num`` is how products are taken: :class:`Exact` (float32, what the tests
use) or any object with ``linear(x, w, b)`` and ``einsum(eq, a, b)`` (a
lower-precision stand-in for a control). ``follow`` may hand the router, per
routing call, the chosen experts to take instead of its own (``None``: its
own choice everywhere).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

IGNORE = -100
ENC = "image_encoder.trunk."
DEC = "text_decoder.trunk.model."


class Exact:
    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a, b)


def _ln(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _rms(p, name, x, eps):
    return p[name + ".weight"] * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def _attend(num, q, k, v, causal: bool):
    """(B, L, H, dq) x (B, L, H, dq) x (B, L, H, dv) -> (B, L, H, dv)."""
    s = num.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        L = s.shape[-1]
        keep = torch.ones(L, L, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return num.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def vit(p: Dict, enc: Dict, images: torch.Tensor, num=Exact()) -> torch.Tensor:
    """timm ``VisionTransformer`` (class token, pre-LN blocks, final norm):
    ``(B, H, W, C)`` -> ``(B, N, D)``."""
    B, H, W, C = images.shape
    ps = enc["patch_size"]
    x = images.reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, (H // ps) * (W // ps), ps * ps * C)
    w = p[ENC + "patch_embed.proj.weight"]
    x = num.linear(x, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                   p[ENC + "patch_embed.proj.bias"])
    x = torch.cat([p[ENC + "cls_token"].expand(B, -1, -1), x], dim=1) + p[ENC + "pos_embed"]
    heads, eps = enc["num_heads"], enc["ln_eps"]
    for i in range(enc["depth"]):
        b = f"{ENC}blocks.{i}."
        h = _ln(p, b + "norm1", x, eps)
        qkv = num.linear(h, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"])
        q, k, v = qkv.view(B, x.shape[1], 3, heads, -1).unbind(2)
        o = _attend(num, q, k, v, causal=False).reshape(B, x.shape[1], -1)
        x = x + num.linear(o, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"])
        h = _ln(p, b + "norm2", x, eps)
        h = F.gelu(num.linear(h, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"]))
        x = x + num.linear(h, p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"])
    return _ln(p, ENC + "norm", x, eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """HF DeepSeek-V3 RoPE on ``x (B, L, H, d)``, positions ``0 .. L - 1``:
    interleaved pairs reordered to halves, then ``x cos + rotate_half(x)
    sin`` with ``inv_freq = theta^(-2i / d)``."""
    B, L, H, d = x.shape
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    x = x.reshape(B, L, H, d // 2, 2).transpose(-1, -2).reshape(B, L, H, d)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def mla(p: Dict, c: Dict, name: str, x: torch.Tensor, num=Exact()) -> torch.Tensor:
    B, L, _ = x.shape
    H, nope, rd, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"], c["kv_lora_rank"])
    q = num.linear(x, p[name + "q_proj.weight"]).view(B, L, H, nope + rd)
    ckv = num.linear(x, p[name + "kv_a_proj_with_mqa.weight"])
    latent, k_pe = ckv[..., :r], ckv[..., r:]
    kv = num.linear(_rms(p, name + "kv_a_layernorm", latent, c["rms_norm_eps"]),
                    p[name + "kv_b_proj.weight"]).view(B, L, H, nope + vd)
    q_pe = rope(q[..., nope:], c["rope_theta"])
    k_pe = rope(k_pe[:, :, None], c["rope_theta"]).expand(B, L, H, rd)
    qf = torch.cat([q[..., :nope], q_pe], -1)
    kf = torch.cat([kv[..., :nope], k_pe], -1)
    o = _attend(num, qf, kf, kv[..., nope:], causal=True)
    return num.linear(o.reshape(B, L, H * vd), p[name + "o_proj.weight"])


def gated_mlp(p: Dict, name: str, x: torch.Tensor, num=Exact()) -> torch.Tensor:
    g = num.linear(x, p[name + "gate_proj.weight"])
    u = num.linear(x, p[name + "up_proj.weight"])
    return num.linear(F.silu(g) * u, p[name + "down_proj.weight"])


def route(p: Dict, c: Dict, name: str, h: torch.Tensor):
    """``(scores s + b (T, E), own choice (T, k), weights function)``: the
    DeepSeek-V3 ``noaux_tc`` gate with one group."""
    s = torch.sigmoid(F.linear(h, p[name + "gate.weight"]))
    biased = s + p[name + "gate.e_score_correction_bias"]
    own = torch.topk(biased.detach(), c["num_experts_per_tok"], dim=-1).indices

    def weights(chosen):
        w = s.gather(1, chosen)
        if c["norm_topk_prob"] and chosen.shape[1] > 1:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * c["routed_scaling_factor"]

    return biased.detach(), own, weights


def moe(p: Dict, c: Dict, name: str, x: torch.Tensor, num=Exact(),
        follow: Optional[torch.Tensor] = None, record: Optional[List] = None) -> torch.Tensor:
    """The expert layer on ``x (B, L, D)``: every expert over the tokens
    that chose it (a mask loop), weighted, plus the shared experts."""
    B, L, D = x.shape
    h = x.reshape(B * L, D)
    scores, own, weights = route(p, c, name, h)
    chosen = own if follow is None else follow
    if record is not None:
        record.append((scores, own))
    w = weights(chosen)
    out = torch.zeros_like(h)
    F_ = c["moe_intermediate_size"]
    for e in range(c["n_routed_experts"]):
        hit = chosen == e  # (T, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w_e = (w * hit).sum(-1)[rows]
        gu = num.linear(h[rows], p[name + "experts.gate_up_proj"][e])
        y = num.linear(F.silu(gu[:, :F_]) * gu[:, F_:], p[name + "experts.down_proj"][e])
        out = out.index_add(0, rows, y * w_e[:, None])
    return out.view(B, L, D) + gated_mlp(p, name + "shared_experts.", x, num)


def hidden(p: Dict, cfg: Dict, images: torch.Tensor, text: torch.Tensor, num=Exact(),
           follow: Optional[List] = None, record: Optional[List] = None) -> torch.Tensor:
    """The text positions' final hidden states ``(B, Lt, D)``. ``cfg``:
    ``encoder`` (ViT sizes) and ``decoder`` (the Moonlight config's keys)."""
    c = cfg["decoder"]
    page = vit(p, cfg["encoder"], images, num)
    page = num.linear(F.gelu(num.linear(page, p["multi_modal_projector.linear_1.weight"],
                                        p["multi_modal_projector.linear_1.bias"])),
                      p["multi_modal_projector.linear_2.weight"],
                      p["multi_modal_projector.linear_2.bias"])
    x = torch.cat([page, F.embedding(text, p[DEC + "embed_tokens.weight"])], dim=1)
    eps = c["rms_norm_eps"]
    calls = 0
    for i in range(c["num_hidden_layers"]):
        b = f"{DEC}layers.{i}."
        x = x + mla(p, c, b + "self_attn.", _rms(p, b + "input_layernorm", x, eps), num)
        h = _rms(p, b + "post_attention_layernorm", x, eps)
        if i < c["first_k_dense_replace"]:
            x = x + gated_mlp(p, b + "mlp.", h, num)
        else:
            x = x + moe(p, c, b + "mlp.", h, num, None if follow is None else follow[calls], record)
            calls += 1
    return _rms(p, DEC + "norm", x[:, page.shape[1]:], eps)


def logits(p: Dict, cfg: Dict, images, text, num=Exact(), **kw) -> torch.Tensor:
    h = hidden(p, cfg, images, text, num, **kw)
    return num.linear(h, p["text_decoder.trunk.lm_head.weight"])


def loss(p: Dict, cfg: Dict, images, text, target, num=Exact(), **kw) -> torch.Tensor:
    """Mean cross entropy over the targets that are not ``IGNORE``: the
    pretrain task's loss on its shifted rows."""
    z = logits(p, cfg, images, text, num, **kw)
    return F.cross_entropy(z.flatten(0, 1), target.flatten(), ignore_index=IGNORE)
