"""Plain PyTorch reference of ``cruller_moonlight``: the ViT, the projector
and Moonlight-16B-A3B's decoder (DeepSeek-V3's latent attention and routed
experts) as a prefix LM, its pretraining loss and its first train steps.
Written from the published equations (timm's ViT, HF ``modeling_deepseek.py``
of DeepSeek-V3, Kimi-VL's MLP projector without the pixel shuffle), in
float32 over a dict of parameters named as the program's checkpoint; no
kernels, no cache, every sequence whole; the experts run as a loop over
experts with masks. Every product goes through :mod:`reference.numerics`,
so the fp8 control rounds them all. It imports nothing of the program (the
same maths as the repository's ``tests/plain_moonlight.py``).

Routing near ties. The router chooses the top k of ``sigmoid(h W_r^T) +
b``; a program that computes ``h`` in bf16 can order two experts whose
scores lie within its rounding otherwise, and from there the two runs
would compute different functions. So the reference is handed the
program's choices of the same steps (``follow``): where its own k-th and
(k+1)-th scores lie at most ``margin`` apart it takes the program's
choice, elsewhere its own, and it keeps its own choice and which tokens
were that sure (``route_gap`` of ``bench_lib.moe`` counts the program's
choices that differ there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference.model import ViT
from reference.numerics import Numerics
from reference.train import AdamW

IGNORE = -100
ENC = "image_encoder.trunk."
DEC = "text_decoder.trunk.model."
HEAD = "text_decoder.trunk.lm_head.weight"
PROJ = "multi_modal_projector."


def parameter_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every parameter's name and shape, and the routers' correction biases
    (buffers of the program: they are weights it is given, not trained).
    The decoder's sizes are the configuration file's top-level keys (HF
    DeepSeek-V3's names), the encoder's its ``encoder`` group."""
    with torch.device("meta"):
        vit = ViT(cfg["encoder"])
    out = {ENC + n: tuple(p.shape) for n, p in vit.named_parameters()}
    c = cfg
    D, E, Fe = c["hidden_size"], c["n_routed_experts"], c["moe_intermediate_size"]
    H, nope, rd, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"], c["kv_lora_rank"])
    De = cfg["encoder"]["embed_dim"]
    out.update({PROJ + "linear_1.weight": (D, De), PROJ + "linear_1.bias": (D,),
                PROJ + "linear_2.weight": (D, D), PROJ + "linear_2.bias": (D,)})
    out[DEC + "embed_tokens.weight"] = (c["vocab_size"], D)
    for i in range(c["num_hidden_layers"]):
        b = f"{DEC}layers.{i}."
        out.update({
            b + "input_layernorm.weight": (D,),
            b + "self_attn.q_proj.weight": (H * (nope + rd), D),
            b + "self_attn.kv_a_proj_with_mqa.weight": (r + rd, D),
            b + "self_attn.kv_a_layernorm.weight": (r,),
            b + "self_attn.kv_b_proj.weight": (H * (nope + vd), r),
            b + "self_attn.o_proj.weight": (D, H * vd),
            b + "post_attention_layernorm.weight": (D,),
        })
        if i < c["first_k_dense_replace"]:
            mlp = {"gate_proj": (c["intermediate_size"], D), "up_proj": (c["intermediate_size"], D),
                   "down_proj": (D, c["intermediate_size"])}
            out.update({f"{b}mlp.{k}.weight": v for k, v in mlp.items()})
        else:
            Fs = Fe * c["n_shared_experts"]
            out.update({
                b + "mlp.gate.weight": (E, D),
                b + "mlp.gate.e_score_correction_bias": (E,),
                b + "mlp.experts.gate_up_proj": (E, 2 * Fe, D),
                b + "mlp.experts.down_proj": (E, D, Fe),
                b + "mlp.shared_experts.gate_proj.weight": (Fs, D),
                b + "mlp.shared_experts.up_proj.weight": (Fs, D),
                b + "mlp.shared_experts.down_proj.weight": (D, Fs),
            })
    out[DEC + "norm.weight"] = (D,)
    out[HEAD] = (c["vocab_size"], D)
    return out


def buffers(cfg: Dict) -> List[str]:
    """The names of :func:`parameter_shapes` that the program holds as
    buffers: not trained, no gradient."""
    return [n for n in parameter_shapes(cfg) if n.endswith("e_score_correction_bias")]


def norm_parameters(cfg: Dict) -> Dict[str, str]:
    """Names of normalisation parameters -> 'weight' or 'bias'."""
    out = {}
    for n, s in parameter_shapes(cfg).items():
        if n.endswith("norm.weight") or n.endswith(("norm1.weight", "norm2.weight")):
            out[n] = "weight"
        elif n.endswith(("norm.bias", "norm1.bias", "norm2.bias")):
            out[n] = "bias"
    return out


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class _RoundedLinear(torch.autograd.Function):
    """``F.linear`` of both operands rounded by ``num.q`` (the fp8 control),
    the gradient passing the rounding unchanged, as ``reference.numerics``
    makes it; the rounded copies are made again in the backward instead of
    being kept for it (a copy of every weight would not fit beside the
    steps' state at 3.19B parameters)."""

    @staticmethod
    def forward(ctx, x, w, b, num):
        ctx.num, ctx.has_bias = num, b is not None
        ctx.save_for_backward(x, w)
        return F.linear(num.q(x), num.q(w), b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        dx = dy @ ctx.num.q(w)
        dw = rows.t() @ ctx.num.q(x).reshape(-1, x.shape[-1])
        return dx, dw, rows.sum(0) if ctx.has_bias else None, None


def _linear(num: Numerics, x, w, b=None):
    """``num.linear``; in fp8 through :class:`_RoundedLinear`, the same
    values without keeping the rounded operands."""
    if num.kind == "fp8":
        return _RoundedLinear.apply(x, w, b, num)
    return num.linear(x, w, b)

def _ln(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _rms(p, name, x, eps):
    return p[name + ".weight"] * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def _attend(num: Numerics, q, k, v, causal: bool):
    """(B, L, H, dq) x (B, L, H, dq) x (B, L, H, dv) -> (B, L, H, dv). The
    scores are scaled and masked in place (neither step's backward reads
    them), so one (B, H, L, L) tensor lives beside the softmax's."""
    s = num.einsum("bqhd,bkhd->bhqk", q, k).mul_(q.shape[-1] ** -0.5)
    if causal:
        L = s.shape[-1]
        drop = torch.ones(L, L, dtype=torch.bool, device=s.device).triu_(1)
        s = s.masked_fill_(drop, torch.finfo(s.dtype).min)
    return num.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def vit(p: Dict, enc: Dict, images: torch.Tensor, num: Numerics) -> torch.Tensor:
    """timm ``VisionTransformer`` (class token, pre-LN blocks, final norm)."""
    B, H, W, C = images.shape
    ps = enc["patch_size"]
    x = images.reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, (H // ps) * (W // ps), ps * ps * C)
    w = p[ENC + "patch_embed.proj.weight"]
    x = _linear(num, x, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                p[ENC + "patch_embed.proj.bias"])
    x = torch.cat([p[ENC + "cls_token"].expand(B, -1, -1), x], dim=1) + p[ENC + "pos_embed"]
    heads, eps = enc["num_heads"], enc["ln_eps"]
    for i in range(enc["depth"]):
        b = f"{ENC}blocks.{i}."
        h = _ln(p, b + "norm1", x, eps)
        qkv = _linear(num, h, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"])
        q, k, v = qkv.view(B, x.shape[1], 3, heads, -1).unbind(2)
        o = _attend(num, q, k, v, causal=False).reshape(B, x.shape[1], -1)
        x = x + _linear(num, o, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"])
        h = _ln(p, b + "norm2", x, eps)
        h = F.gelu(_linear(num, h, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"]))
        x = x + _linear(num, h, p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"])
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


def mla(p: Dict, c: Dict, name: str, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    B, L, _ = x.shape
    H, nope, rd, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"], c["kv_lora_rank"])
    q = _linear(num, x, p[name + "q_proj.weight"]).view(B, L, H, nope + rd)
    ckv = _linear(num, x, p[name + "kv_a_proj_with_mqa.weight"])
    kv = _linear(num, _rms(p, name + "kv_a_layernorm", ckv[..., :r], c["rms_norm_eps"]),
                    p[name + "kv_b_proj.weight"]).view(B, L, H, nope + vd)
    q_pe = rope(q[..., nope:], c["rope_theta"])
    k_pe = rope(ckv[..., r:][:, :, None], c["rope_theta"]).expand(B, L, H, rd)
    o = _attend(num, torch.cat([q[..., :nope], q_pe], -1), torch.cat([kv[..., :nope], k_pe], -1),
                kv[..., nope:], causal=True)
    return _linear(num, o.reshape(B, L, H * vd), p[name + "o_proj.weight"])


def gated_mlp(p: Dict, name: str, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    g = _linear(num, x, p[name + "gate_proj.weight"])
    u = _linear(num, x, p[name + "up_proj.weight"])
    return _linear(num, F.silu(g) * u, p[name + "down_proj.weight"])


class Router:
    """How the reference's router chooses: its own top k where the k-th and
    (k+1)-th scores lie more than ``margin`` apart, else the choice in
    ``follow`` (the program's, per routing call and token; None: its own
    everywhere). Each call appends ``(scores, own, sure)`` to ``record``."""

    def __init__(self, margin: float = 0.0, follow: Optional[Sequence[torch.Tensor]] = None):
        self.margin = margin
        self.follow = follow
        self.record: List = []

    def choose(self, biased: torch.Tensor, k: int, rows: slice) -> torch.Tensor:
        top = torch.topk(biased, k + 1, dim=-1)
        own = top.indices[:, :k]
        sure = (top.values[:, k - 1] - top.values[:, k]) > self.margin
        self.record.append((biased, own, sure))
        if self.follow is None:
            return own
        given = self.follow[len(self.record) - 1][rows].to(own.device, torch.int64)
        return torch.where(sure[:, None], own, given)


def moe(p: Dict, c: Dict, name: str, x: torch.Tensor, num: Numerics, router: Router,
        rows: slice) -> torch.Tensor:
    """The expert layer on ``x (B, L, D)``; ``rows``: the tokens' rows in
    the whole batch's flattened ``(B * L)`` order (``follow``'s)."""
    B, L, D = x.shape
    h = x.reshape(B * L, D)
    s = torch.sigmoid(F.linear(h, p[name + "gate.weight"]))  # fp32, as the program's router
    biased = s + p[name + "gate.e_score_correction_bias"]
    chosen = router.choose(biased.detach(), c["num_experts_per_tok"], rows)
    w = s.gather(1, chosen)
    if c["norm_topk_prob"] and chosen.shape[1] > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * c["routed_scaling_factor"]
    out = torch.zeros_like(h)
    Fe = c["moe_intermediate_size"]
    for e in range(c["n_routed_experts"]):
        hit = chosen == e  # (T, k)
        sel = hit.any(-1).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        gu = _linear(num, h[sel], p[name + "experts.gate_up_proj"][e])
        y = _linear(num, F.silu(gu[:, :Fe]) * gu[:, Fe:], p[name + "experts.down_proj"][e])
        out = out.index_add(0, sel, y * (w * hit).sum(-1)[sel][:, None])
    return out.view(B, L, D) + gated_mlp(p, name + "shared_experts.", x, num)


def hidden(p: Dict, cfg: Dict, images, text, num: Numerics, router: Router,
           rows: slice) -> torch.Tensor:
    """The text positions' final hidden states ``(B, Lt, D)``."""
    c = cfg
    page = vit(p, cfg["encoder"], images, num)
    page = F.gelu(_linear(num, page, p[PROJ + "linear_1.weight"], p[PROJ + "linear_1.bias"]))
    page = _linear(num, page, p[PROJ + "linear_2.weight"], p[PROJ + "linear_2.bias"])
    x = torch.cat([page, F.embedding(text, p[DEC + "embed_tokens.weight"])], dim=1)
    eps = c["rms_norm_eps"]
    L = x.shape[1]
    tok = slice(rows.start * L, rows.stop * L)
    for i in range(c["num_hidden_layers"]):
        b = f"{DEC}layers.{i}."
        x = x + mla(p, c, b + "self_attn.", _rms(p, b + "input_layernorm", x, eps), num)
        h = _rms(p, b + "post_attention_layernorm", x, eps)
        if i < c["first_k_dense_replace"]:
            x = x + gated_mlp(p, b + "mlp.", h, num)
        else:
            x = x + moe(p, c, b + "mlp.", h, num, router, tok)
    return _rms(p, DEC + "norm", x[:, page.shape[1]:], eps)


# --------------------------------------------------------------------------
# the first train steps
# --------------------------------------------------------------------------

def train_readings(params: Dict[str, torch.Tensor], cfg: Dict, num: Numerics, batches, opt: Dict,
                   chunk_rows: int, device, margin: float = 0.0,
                   follow: Optional[List] = None) -> Dict:
    """Run ``len(batches)`` train steps from ``params`` (float32, changed in
    place; the buffers of :func:`buffers` stay as given): each step's loss
    (mean cross entropy over the shifted rows' valid targets), the first
    gradient's norm per leaf, the parameters themselves after the last step
    (``params``), and per step and routing call the router's scores, its
    own choice and which tokens were sure (``routes``). ``follow``: per
    step, the program's choices per routing call (see :class:`Router`).
    The batch runs in chunks of ``chunk_rows`` rows whose gradients add up
    to the whole batch's."""
    fixed = set(buffers(cfg))
    leaves = {n: t.requires_grad_(True) for n, t in params.items() if n not in fixed}
    adam = AdamW(opt, leaves)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    routes: List = []
    for k, batch in enumerate(batches):
        text = torch.as_tensor(batch["text"][:, :-1], device=device)
        target = torch.as_tensor(batch["target"][:, 1:], device=device)
        B = text.shape[0]
        n_valid = (target != IGNORE).sum().clamp_min(1).float()
        router = Router(margin, None if follow is None else follow[k])
        per_call: List = []
        total = torch.zeros((), device=device)
        for t in leaves.values():
            t.grad = None
        for r0 in range(0, B, chunk_rows):
            rows = slice(r0, min(B, r0 + chunk_rows))
            img = torch.as_tensor(batch["image"][rows], device=device, dtype=torch.float32)
            router.record = []
            h = hidden(params, cfg, img, text[rows], num, router, rows)
            z = _linear(num, h, params[HEAD])
            nll = F.cross_entropy(z.flatten(0, 1), target[rows].flatten(), ignore_index=IGNORE,
                                  reduction="sum")
            (nll / n_valid).backward()
            total += nll.detach()
            per_call.append([(s.cpu(), o.to(torch.int16).cpu(), y.cpu())
                             for s, o, y in router.record])
            del z, h, nll
        routes.append([tuple(torch.cat([chunk[j][i] for chunk in per_call]) for i in range(3))
                       for j in range(len(per_call[0]))])
        losses.append(float(total / n_valid))
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in leaves.items()}
        if k == 0:
            norms = torch._foreach_norm(list(grads.values()))
            grad_norms = {n: float(v) for n, v in zip(grads, norms)}
        adam.step(leaves, grads)
        for t in leaves.values():
            t.grad = None
    for t in leaves.values():
        t.requires_grad_(False)
    del adam
    return {"losses": losses, "grad_norms": grad_norms, "routes": routes}
