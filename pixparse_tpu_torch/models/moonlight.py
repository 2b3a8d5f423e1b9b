"""Moonlight-16B-A3B's decoder (DeepSeek-V3's layers: latent attention and
sparse experts) as a prefix language model behind the Cruller image encoder.

:class:`MoonlightCruller` runs the ViT over the page, projects its rows into
the decoder's width (``multi_modal_projector``: Linear -> GELU -> Linear,
as Kimi-VL's MLP projector without its pixel shuffle) and puts them ahead
of the text in one causal sequence: the page rows take positions ``0 ..
N - 1``, the text ``N ..``. RoPE positions run over the whole sequence.
The text positions' hidden states go to the untied head.

Each decoder layer is ``x + Attn(RMSNorm(x))``, then ``+ FFN(RMSNorm(.))``:

- attention (MLA, ``q_lora_rank`` null): ``q = W_q h`` split per head into
  ``q_nope`` (128) and ``q_pe`` (64); ``[c, k_pe] = W_kva h`` with the latent
  ``c`` (512) and one ``k_pe`` (64) shared by the heads; ``c <-
  RMSNorm(c)``; ``[k_nope, v] = W_kvb c`` per head (128 + 128); RoPE on
  ``q_pe`` and ``k_pe`` with interleaved pairs, reordered as HF
  ``modeling_deepseek.py`` does; ``softmax([q_nope, q_pe] . [k_nope,
  k_pe]^T / sqrt(192) + causal) v``, then ``W_o``;
- FFN: a SwiGLU MLP in the first ``first_k_dense_replace`` layers, then the
  expert layer (``ops/moe.py``): the router in fp32, the top-k experts by
  ``sigmoid(h W_r^T) + b``, weights ``s`` at the chosen experts normalised
  and scaled, the weighted sum of the chosen SwiGLU experts, plus the
  shared experts' SwiGLU MLP (``n_shared_experts`` x the expert width).

No dropout (Moonlight declares none). The correction bias ``b`` is a buffer:
it gets no gradient and the train step does not move it.

Parameter names follow HF ``DeepseekV3ForCausalLM`` under
``text_decoder.trunk.``: ``model.embed_tokens``,
``model.layers.N.{input_layernorm, post_attention_layernorm}``,
``model.layers.N.self_attn.{q_proj, kv_a_proj_with_mqa, kv_a_layernorm,
kv_b_proj, o_proj}``, ``model.layers.N.mlp.{gate_proj, up_proj,
down_proj}`` (dense), ``model.layers.N.mlp.gate.{weight,
e_score_correction_bias}``, ``model.layers.N.mlp.shared_experts.{gate_proj,
up_proj, down_proj}``, ``model.norm``, ``lm_head``. The routed experts are
stacked: ``mlp.experts.gate_up_proj`` ``(E, 2F, D)`` holds HF's
``mlp.experts.{e}.gate_proj.weight`` in rows ``[0, F)`` of ``[e]`` and
``mlp.experts.{e}.up_proj.weight`` in rows ``[F, 2F)``;
``mlp.experts.down_proj`` ``(E, D, F)`` holds ``mlp.experts.{e}.down_proj.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.models.remat import block_mode, checkpoint_region, mlp_mode, set_remat
from pixparse_tpu_torch.models.vit import ViT
from pixparse_tpu_torch.ops.dense import Linear, rms_norm
from pixparse_tpu_torch.ops.moe import routed_experts, swiglu


@dataclasses.dataclass(frozen=True)
class MoonlightCfg:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    max_length: int = 1024  # text positions (the task's collate length)

    @property
    def d_model(self) -> int:
        return self.hidden_size

    @property
    def decoder_layers(self) -> int:
        return self.num_hidden_layers

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# decoder name -> its published sizes (and a test size)
MOONLIGHT_ARCH_TABLE = {
    # https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
    "moonshotai/Moonlight-16B-A3B": {},
    "moonlight-test": dict(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
        moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=3, max_position_embeddings=512,
    ),
}


def resolve_moonlight_cfg(name: str, num_decoder_layers: Optional[int] = None,
                          max_length: Optional[int] = None,
                          vocab_size: Optional[int] = None) -> MoonlightCfg:
    """Decoder name -> :class:`MoonlightCfg`; the registry's layer count,
    text length and the tokenizer's vocabulary override the table's."""
    if name not in MOONLIGHT_ARCH_TABLE:
        raise ValueError(
            f"unknown Moonlight decoder {name!r} (known: {sorted(MOONLIGHT_ARCH_TABLE)})")
    arch = dict(MOONLIGHT_ARCH_TABLE[name])
    for key, value in (("num_hidden_layers", num_decoder_layers), ("max_length", max_length),
                       ("vocab_size", vocab_size)):
        if value:
            arch[key] = value
    return MoonlightCfg(**arch)


def is_moonlight(name: str) -> bool:
    return name in MOONLIGHT_ARCH_TABLE


def rope_tables(cfg: MoonlightCfg, length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``(length, rope_dim)`` fp32 for positions ``0 ..
    length - 1`` (no rope scaling), halves repeated as HF lays them out."""
    d = cfg.qk_rope_head_dim
    exponents = torch.arange(0, d, 2, device=device, dtype=torch.float32) / d
    inv_freq = 1.0 / cfg.rope_theta ** exponents
    freqs = torch.outer(torch.arange(length, device=device, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on ``x (B, L, H, d)`` with interleaved pairs: ``(x0, x1), (x2,
    x3), ...`` are first reordered to ``(x0, x2, ..., x1, x3, ...)``, then
    rotated by halves (HF ``apply_rotary_pos_emb`` of DeepSeek-V3); fp32,
    rounded once to ``x``'s dtype."""
    B, L, H, d = x.shape
    xf = x.float().reshape(B, L, H, d // 2, 2).transpose(-1, -2).reshape(B, L, H, d)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class MLAttention(nn.Module):
    """Multi-head latent attention in its training form (``q_lora_rank``
    null): keys and values are expanded from the latent for every head."""

    def __init__(self, cfg: MoonlightCfg):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Linear(D, H * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = Linear(D, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                bias=False)
        self.o_proj = Linear(H * cfg.v_head_dim, D, bias=False)

    def forward(self, x, cos, sin):
        c = self.cfg
        B, L, _ = x.shape
        H, nope, rope_d = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q_nope, q_pe = self.q_proj(x).view(B, L, H, nope + rope_d).split([nope, rope_d], -1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope_d], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(B, L, H, nope + c.v_head_dim)
        k_nope, v = kv.split([nope, c.v_head_dim], -1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, :, None], cos, sin).expand(B, L, H, rope_d)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe], -1).transpose(1, 2)
        # A stated stopgap: PyTorch's fused attention. No kernel of the port
        # takes a query and key 192 wide with values 128 wide (the flash
        # kernels take equal widths of 32, 64 or 128), and the scores are
        # about 4% of a cruller_moonlight train step. A hand-written MLA
        # attention is queued (ROADMAP Queue 1).
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2), is_causal=True,
                                           scale=c.qk_head_dim ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(B, L, H * c.v_head_dim))


class GatedMLP(nn.Module):
    """``down(silu(gate(x)) * up(x))``: the dense layer and the shared
    experts."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = Linear(dim, hidden, bias=False)
        self.up_proj = Linear(dim, hidden, bias=False)
        self.down_proj = Linear(hidden, dim, bias=False)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class Router(nn.Module):
    def __init__(self, cfg: MoonlightCfg):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.register_buffer("e_score_correction_bias", torch.zeros(cfg.n_routed_experts))


class Experts(nn.Module):
    """The routed experts' weights, stacked (see the module docstring)."""

    def __init__(self, cfg: MoonlightCfg):
        super().__init__()
        E, D, Fe = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * Fe, D))
        self.down_proj = nn.Parameter(torch.empty(E, D, Fe))


class MoE(nn.Module):
    def __init__(self, cfg: MoonlightCfg, layer: int):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = GatedMLP(cfg.hidden_size,
                                       cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, x):
        c = self.cfg
        B, L, D = x.shape
        routed = routed_experts(
            x.reshape(B * L, D), self.gate.weight, self.gate.e_score_correction_bias,
            self.experts.gate_up_proj.to(x.dtype), self.experts.down_proj.to(x.dtype),
            c.num_experts_per_tok, c.routed_scaling_factor, c.norm_topk_prob, self.layer)
        return routed.view(B, L, D) + self.shared_experts(x)


class DecoderLayer(nn.Module):
    """Pre-RMSNorm layer; remat ``'full'``/``'dots'`` checkpoints it whole,
    ``'mlp'``/``'gelu'`` its FFN (the recompute then routes again)."""

    remat_mode = False

    def __init__(self, cfg: MoonlightCfg, layer: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (GatedMLP(cfg.hidden_size, cfg.intermediate_size)
                    if layer < cfg.first_k_dense_replace else MoE(cfg, layer))

    def _ffn(self, x):
        return self.mlp(self.post_attention_layernorm(x))

    def _layer(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        if mlp_mode(self.remat_mode):
            return x + checkpoint_region(self._ffn, x)
        return x + self._ffn(x)

    def forward(self, x, cos, sin):
        cut = block_mode(self.remat_mode)
        if cut:
            return checkpoint_region(self._layer, x, cos, sin, dots=cut == "dots")
        return self._layer(x, cos, sin)


class MoonlightModel(nn.Module):
    def __init__(self, cfg: MoonlightCfg):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MoonlightDecoder(nn.Module):
    """HF ``DeepseekV3ForCausalLM``'s modules: ``model`` and the untied
    ``lm_head``. :meth:`forward` takes the input rows already embedded."""

    def __init__(self, cfg: MoonlightCfg):
        super().__init__()
        self.cfg = cfg
        self.model = MoonlightModel(cfg)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def embed(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(ids, self.model.embed_tokens.weight).to(dtype)

    def forward(self, x: torch.Tensor, keep_from: int = 0) -> torch.Tensor:
        """``x (B, L, D)`` -> the final-normed hidden states of positions
        ``keep_from ..`` (the norm is per position)."""
        cos, sin = rope_tables(self.cfg, x.shape[1], x.device)
        for layer in self.model.layers:
            x = layer(x, cos, sin)
        return self.model.norm(x[:, keep_from:])


class Projector(nn.Module):
    def __init__(self, enc_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(enc_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


class MoonlightCruller(nn.Module):
    """ViT encoder -> projector -> Moonlight decoder over ``[page rows;
    text]``. Parameters are created in fp32 on the CPU (the routed experts
    uninitialised until :meth:`init_weights` or a loaded state dict);
    ``compute_dtype`` is the forward's dtype when it differs from the
    parameters'. ``attn_impl`` reaches the encoder (the decoder's attention
    is the fused-attention stopgap either way). ``remat``: the remat mode
    of the encoder and the decoder layers (``models/remat.py``)."""

    tied_head = False

    def __init__(self, vit_cfg, dec_cfg: MoonlightCfg, attn_impl: str = "xla",
                 compute_dtype: Optional[torch.dtype] = None, remat=False):
        super().__init__()
        self.vit_cfg = vit_cfg
        self.dec_cfg = dec_cfg
        self.compute_dtype = compute_dtype
        self.image_encoder = nn.ModuleDict({"trunk": ViT(vit_cfg, attn_impl, compute_dtype)})
        self.multi_modal_projector = Projector(vit_cfg.embed_dim, dec_cfg.hidden_size)
        self.text_decoder = nn.ModuleDict({"trunk": MoonlightDecoder(dec_cfg)})
        self.remat = remat

    @property
    def remat(self):
        return self._remat

    @remat.setter
    def remat(self, mode):
        set_remat(self, mode)
        self._remat = mode

    @property
    def encoder(self) -> ViT:
        return self.image_encoder["trunk"]

    @property
    def decoder(self) -> MoonlightDecoder:
        return self.text_decoder["trunk"]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoonlightCruller":
        """The encoder's own init; elsewhere HF DeepSeek-V3's: normal(0,
        0.02) weights, zero biases, unit norms, a zero correction bias."""
        self.encoder.init_weights(generator)
        for name, p in self.named_parameters():
            if name.startswith("image_encoder."):
                continue
            if name.endswith(".bias"):
                p.zero_()
            elif name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        for layer in self.decoder.model.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.e_score_correction_bias.zero_()
        return self

    def encode(self, image_input: torch.Tensor) -> torch.Tensor:
        return self.encoder(image_input)

    def forward_hidden(self, image_input, text_input) -> torch.Tensor:
        """The text positions' final hidden states ``(B, Lt, D)``."""
        page = self.multi_modal_projector(self.encode(image_input))
        text = self.decoder.embed(text_input, page.dtype)
        return self.decoder(torch.cat([page, text], dim=1), keep_from=page.shape[1])

    def forward_hidden_head(self, image_input, text_input):
        """:meth:`forward_hidden`, the head's table and no vocabulary shard:
        what the train tasks' loss reads."""
        return self.forward_hidden(image_input, text_input), self.decoder.lm_head.weight, None

    def forward(self, image_input, text_input) -> torch.Tensor:
        """Teacher-forced logits of the text positions ``(B, Lt, V)`` fp32."""
        h = self.forward_hidden(image_input, text_input)
        return F.linear(h, self.decoder.lm_head.weight.to(h.dtype)).float()
