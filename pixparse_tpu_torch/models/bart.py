"""BART-style causal decoder with cross-attention (counterpart of
:mod:`pixparse_tpu.models.bart`).

Post-LN transformer decoder (pre-LN + final LN for the mBART layout),
learned positions with the BART +2 offset, embedding LayerNorm, exact-erf
GELU FFN, tied LM head. Parameter names follow HF ``BartForCausalLM``
(``model.decoder.layers.N.self_attn.q_proj`` ..., ``lm_head``), so a
reference checkpoint's ``text_decoder.trunk.*`` entries load as they are.

Three modes, as in JAX:

- ``train``: teacher-forced parallel forward, no cache;
- ``prefill``: runs the prompt, fills the self-attention cache at
  ``[0, L)`` and computes the cross-attention K/V once per image;
- ``decode``: one token per step against the cache. Both attentions go
  through :func:`~pixparse_tpu_torch.ops.decode_attention.decode_attention`
  (the CUDA kernel on the card).

The cache is an explicit :class:`KVCache` passed in and updated in place.
Caches are stored flat, ``(B, len_pad, H*D)`` with ``len_pad`` rounded up to
a multiple of 128, the layout the decode kernels stream.

``kv_cache_dtype='int8'`` (the JAX package's int8 decode mode): prefill
quantizes the cross-attention K/V per (sample, position, head) into int8
caches plus fp32 scales and itself attends over the exact projections;
single-token decode steps run
:func:`~pixparse_tpu_torch.ops.decode_attention.decode_attention_q8`. The
self-attention caches stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixparse_tpu_torch.models.remat import block_mode, checkpoint_region, mlp_mode
from pixparse_tpu_torch.ops.attention import NEG_MIN, dot_product_attention, mask_lens
from pixparse_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_q8,
    quantize_kv_rows,
)
from pixparse_tpu_torch.ops.dense import Linear, dropout
from pixparse_tpu_torch.ops.layer_norm import LayerNorm
from pixparse_tpu_torch.parallel.tensor_parallel import (
    TPLayout,
    copy_to_model,
    gather_whole,
    shard_seed,
    vocab_parallel_embedding,
)


@dataclasses.dataclass(frozen=True)
class BartDecoderCfg:
    vocab_size: int = 50265
    d_model: int = 768
    decoder_layers: int = 4
    decoder_attention_heads: int = 12
    decoder_ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    activation: str = "gelu"
    scale_embedding: bool = False
    layernorm_embedding: bool = True
    add_final_layer_norm: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    ln_eps: float = 1e-5
    pos_offset: int = 2  # BART quirk: positional table shifted by 2
    pre_norm: bool = False  # mBART/Donut decoder: pre-LN layers + final LN


DECODE_DTYPES = ("bf16", "int8")  # kv_cache_dtype / lm_head_dtype


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


@dataclass
class KVCache:
    """Decode state of one generation. Prefill fills it and every decode
    step updates it IN PLACE: the self caches are written by slice
    assignment and ``index`` (positions written so far) advances.

    Per layer: ``self_k``/``self_v`` ``(B, len_pad, H*D)`` with ``len_pad``
    = ``max_len`` rounded up to 128; ``cross_k``/``cross_v``
    ``(B, Lk_pad, H*D)`` zero-padded from the encoder length (int8 in the
    int8 mode, with ``cross_k_scale``/``cross_v_scale`` ``(B, H, Lk_pad)``
    fp32, padded with 1); ``qkv`` the self-attention q/k/v projections fused
    into one weight and bias, built once at prefill (the decode step runs one
    GEMM instead of three). ``cross_mask`` ``(B, Lk_pad)`` marks the real
    encoder keys."""

    max_len: int
    index: int = 0
    self_k: List[torch.Tensor] = field(default_factory=list)
    self_v: List[torch.Tensor] = field(default_factory=list)
    cross_k: List[torch.Tensor] = field(default_factory=list)
    cross_v: List[torch.Tensor] = field(default_factory=list)
    cross_k_scale: List[torch.Tensor] = field(default_factory=list)
    cross_v_scale: List[torch.Tensor] = field(default_factory=list)
    qkv: List[Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=list)
    cross_mask: Optional[torch.Tensor] = None

    def repeat_rows(self, n: int) -> None:
        """Each row's caches, scales and cross mask repeated ``n`` times in
        its place (``repeat_interleave`` on dim 0): one prefill per sample
        serves the sample's ``n`` beams. The fused q/k/v weights are
        shared."""
        for caches in (self.self_k, self.self_v, self.cross_k, self.cross_v,
                       self.cross_k_scale, self.cross_v_scale):
            caches[:] = [c.repeat_interleave(n, dim=0) for c in caches]
        if self.cross_mask is not None:
            self.cross_mask = self.cross_mask.repeat_interleave(n, dim=0)

    def reorder(self, src: torch.Tensor) -> None:
        """Beam reorder: row ``r`` of every layer's self caches takes row
        ``src[r]``'s. Only the written prefix ``[:, :index]`` is gathered
        (the rest is unwritten zeros) and written back into the same
        buffers, which keep the contiguous ``(rows, len_pad, H*D)`` layout
        the decode kernel requires. The cross caches, their scales and
        ``cross_mask`` stay: beam search reorders rows only within a sample,
        and every beam of a sample holds the same encoder rows."""
        i = self.index
        for caches in (self.self_k, self.self_v):
            for c in caches:
                c[:, :i] = c[:, :i].index_select(0, src)

    # continuous batching (ops/serving.py): a persistent cache of slot rows
    # takes staged pages' rows; each buffer is written in place, so it keeps
    # the contiguous layout the decode kernels require

    def splice_rows(self, rows: torch.Tensor, pool: "KVCache", src: torch.Tensor) -> None:
        """Rows ``rows`` of every layer's cross caches, their int8 scales
        and ``cross_mask`` take ``pool``'s rows ``src``."""
        for mine, theirs in ((self.cross_k, pool.cross_k), (self.cross_v, pool.cross_v),
                             (self.cross_k_scale, pool.cross_k_scale),
                             (self.cross_v_scale, pool.cross_v_scale)):
            for c, p in zip(mine, theirs):
                c[rows] = p[src]
        self.cross_mask[rows] = pool.cross_mask[src]

    def splice_prompt(self, rows: torch.Tensor, pool: "KVCache", src: torch.Tensor,
                      col: int, n: int) -> None:
        """Rows ``rows`` of every layer's self K/V take ``pool``'s rows
        ``src``' columns ``[0, n)`` (a prefilled prompt block) at the shared
        columns ``[col, col + n)``."""
        for mine, theirs in ((self.self_k, pool.self_k), (self.self_v, pool.self_v)):
            for c, p in zip(mine, theirs):
                c[rows, col:col + n] = p[src, :n]

    def compact(self, mask: torch.Tensor) -> torch.Tensor:
        """Each row's self K/V columns where ``mask`` ``(rows, C)`` is True
        gathered to the left of every layer's buffers, in order (an exact
        copy: masked keys have zero weight wherever they sit). Returns the
        new mask, each row's first ``mask.sum()`` columns."""
        C = mask.shape[1]
        order = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices
        for caches in (self.self_k, self.self_v):
            for c in caches:
                idx = order[:, :, None].expand(-1, -1, c.shape[2])
                c[:, :C] = torch.gather(c[:, :C], 1, idx)
        return torch.arange(C, device=mask.device)[None, :] < mask.sum(dim=1, keepdim=True)


class _Projections(nn.Module):
    """q/k/v/out projections with HF BART names. Under tensor parallelism
    (``tp``) q/k/v are column-parallel (this rank's heads, their count read
    off the weight) and ``out_proj`` row-parallel; the caches of prefill and
    decode hold the rank's heads only, ``(B, len, Hl*Dh)``."""

    tp = None  # TPGroup (parallel/tensor_parallel.py)

    def _local_heads(self, D: int) -> int:
        return self.q_proj.weight.shape[0] // (D // self.num_heads)

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)


class CachedSelfAttention(_Projections):
    """Causal self-attention. ``train``: full-length causal attention;
    ``prefill``: writes K/V at ``[0, L)`` and attends over the cache with a
    causal + key-pad bias; ``decode``: writes K/V at ``index`` and runs the
    decode kernel over the cache gated by ``valid`` (keys ``<= index`` and
    not pad)."""

    def forward(self, x, mode, attn_impl, bias=None, valid=None, cache=None, layer=0):
        B, L, D = x.shape
        Hl, Dh = self._local_heads(D), D // self.num_heads
        Dl = Hl * Dh  # this rank's heads, flat
        x = copy_to_model(x, self.tp)
        if mode == "train":
            q = self.q_proj(x).view(B, L, Hl, Dh)
            k = self.k_proj(x).view(B, L, Hl, Dh)
            v = self.v_proj(x).view(B, L, Hl, Dh)
            out = dot_product_attention(
                q, k, v, bias=bias, causal=True, dtype=x.dtype, impl=attn_impl
            )
            return self.out_proj(out.reshape(B, L, Dl))

        if mode == "prefill":
            cache.qkv.append((
                torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]),
                torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]),
            ))
            len_pad = _pad128(cache.max_len)
            cache.self_k.append(x.new_zeros(B, len_pad, Dl))
            cache.self_v.append(x.new_zeros(B, len_pad, Dl))
        w, b = cache.qkv[layer]
        qf, kf, vf = F.linear(x, w, b).split(Dl, dim=-1)  # (B, L, Dl) heads flat
        k_cache, v_cache = cache.self_k[layer], cache.self_v[layer]
        i = cache.index
        k_cache[:, i:i + L] = kf
        v_cache[:, i:i + L] = vf
        if mode == "decode" and L == 1:
            out = decode_attention(qf, k_cache, v_cache, valid, num_heads=Hl)
        else:
            T = cache.max_len
            out = dot_product_attention(
                qf.reshape(B, L, Hl, Dh),
                k_cache[:, :T].view(B, T, Hl, Dh),
                v_cache[:, :T].view(B, T, Hl, Dh),
                bias=bias, dtype=x.dtype,
            )
        return self.out_proj(out.reshape(B, L, Dl))


class CachedCrossAttention(_Projections):
    """Cross-attention over encoder tokens; in ``prefill`` the K/V are
    computed once and cached (quantized in the int8 mode), ``decode`` reuses
    them through the decode kernel."""

    def __init__(self, d_model: int, num_heads: int, kv_cache_dtype: str = "bf16"):
        super().__init__(d_model, num_heads)
        self.kv_cache_dtype = kv_cache_dtype

    def _dequantized(self, cache, layer, Lk, dtype):
        """The int8 caches' first Lk positions, dequantized (multi-token
        decode steps only)."""
        out = []
        for c, sc in ((cache.cross_k, cache.cross_k_scale), (cache.cross_v, cache.cross_v_scale)):
            B, _, D = c[layer].shape
            H = self.num_heads
            x = c[layer][:, :Lk].float().reshape(B, Lk, H, D // H)
            scale = sc[layer][:, :H, :Lk].transpose(1, 2)[..., None]
            out.append((x * scale).to(dtype).reshape(B, Lk, D))
        return out

    def forward(self, x, enc, mode, attn_impl, kv_lens=None, valid=None, cache=None, layer=0):
        """``kv_lens``: ``(B,)`` leading real encoder keys per sample (train,
        prefill and multi-token steps; the flash kernel takes them in train
        mode); ``valid``: the decode kernel's boolean key mask."""
        B, L, D = x.shape
        Lk = enc.shape[1]
        q8 = self.kv_cache_dtype == "int8"
        H = self._local_heads(D)  # this rank's heads
        if self.tp is not None:
            x, enc = copy_to_model(x, self.tp), copy_to_model(enc, self.tp)
        qf = self.q_proj(x)
        if mode == "decode" and L == 1:
            if q8:
                out = decode_attention_q8(
                    qf, cache.cross_k[layer], cache.cross_v[layer], cache.cross_k_scale[layer],
                    cache.cross_v_scale[layer], valid, num_heads=H,
                )
            else:
                out = decode_attention(
                    qf, cache.cross_k[layer], cache.cross_v[layer], valid, num_heads=H
                )
            return self.out_proj(out)
        if mode == "decode":  # multi-token step: plain attention over the cache
            if q8:
                k, v = self._dequantized(cache, layer, Lk, x.dtype)
            else:
                k = cache.cross_k[layer][:, :Lk]
                v = cache.cross_v[layer][:, :Lk]
        else:
            # prefill attends over these exact projections, never the
            # quantized cache
            k, v = self.k_proj(enc), self.v_proj(enc)
            if mode == "prefill":
                pad = (0, 0, 0, _pad128(Lk) - Lk)
                if q8:
                    for t, store, scales in ((k, cache.cross_k, cache.cross_k_scale),
                                             (v, cache.cross_v, cache.cross_v_scale)):
                        t_i8, t_scale = quantize_kv_rows(t, H)
                        store.append(F.pad(t_i8, pad))
                        scales.append(F.pad(t_scale, (0, _pad128(Lk) - Lk), value=1.0))
                else:
                    cache.cross_k.append(F.pad(k, pad))
                    cache.cross_v.append(F.pad(v, pad))
        Dh = D // self.num_heads
        out = dot_product_attention(
            qf.view(B, L, H, Dh), k.reshape(B, Lk, H, Dh), v.reshape(B, Lk, H, Dh),
            dtype=x.dtype, impl=attn_impl if mode == "train" else "xla", kv_lens=kv_lens,
        )
        return self.out_proj(out.reshape(B, L, H * Dh))


class BartDecoderLayer(nn.Module):
    """Post-LN (BART) or pre-LN (mBART) decoder layer. In ``mode='train'``
    with gradients on it follows the remat mode (``models/remat.py``): the
    FFN checkpointed under ``'mlp'`` (fc1, GELU, activation dropout, fc2) or
    ``'gelu'`` (all but fc1), the whole layer under ``'full'``/``'dots'``; the
    dropout generators are replayed in the recompute. The activation dropout
    (inside fc1's columns, split under tensor parallelism) draws from
    ``shard_generator``, every other dropout from ``generator``."""

    remat_mode = False
    tp = None  # TPGroup: fc1 column-, fc2 row-parallel

    def __init__(self, cfg: BartDecoderCfg, kv_cache_dtype: str = "bf16"):
        super().__init__()
        D, H = cfg.d_model, cfg.decoder_attention_heads
        self.pre_norm = cfg.pre_norm
        self.self_attn = CachedSelfAttention(D, H)
        self.self_attn_layer_norm = LayerNorm(D, cfg.ln_eps)
        self.encoder_attn = CachedCrossAttention(D, H, kv_cache_dtype)
        self.encoder_attn_layer_norm = LayerNorm(D, cfg.ln_eps)
        self.fc1 = Linear(D, cfg.decoder_ffn_dim)
        self.fc2 = Linear(cfg.decoder_ffn_dim, D)
        self.final_layer_norm = LayerNorm(D, cfg.ln_eps)
        self.dropout = cfg.dropout
        self.activation_dropout = cfg.activation_dropout

    def _ffn_tail(self, h, live, generator):
        h = F.gelu(h)  # exact erf GELU
        h = dropout(h, self.activation_dropout, live, generator)
        return self.fc2(h)

    def _ffn(self, h, live, generator):
        return self._ffn_tail(self.fc1(h), live, generator)

    def forward(self, x, enc, mode, attn_impl, masks, cache=None, layer=0, generator=None,
                shard_generator=None):
        """``generator`` and ``shard_generator`` (default: ``generator``)
        feed the dropout masks; dropout is live only when the module is in
        training mode and ``mode == 'train'``."""
        live = self.training and mode == "train"
        remat = self.remat_mode if mode == "train" else False
        if shard_generator is None:
            shard_generator = generator
        # the streams dropout draws from inside a checkpointed region
        streams = (generator,) if shard_generator is generator else (generator, shard_generator)
        replay = streams if live and generator is not None else None
        cut = block_mode(remat)
        if cut:
            return checkpoint_region(
                self._layer, x, enc, mode, attn_impl, masks, cache, layer, generator,
                shard_generator, remat, dots=cut == "dots", generator=replay,
            )
        return self._layer(x, enc, mode, attn_impl, masks, cache, layer, generator,
                           shard_generator, remat)

    def _layer(self, x, enc, mode, attn_impl, masks, cache, layer, generator, shard_generator,
               remat):
        self_bias, self_valid, cross_lens, cross_valid = masks
        live = self.training and mode == "train"
        drop = lambda h: dropout(h, self.dropout, live, generator)
        self_attn = lambda h: drop(self.self_attn(
            h, mode, attn_impl, self_bias, self_valid, cache, layer
        ))
        cross_attn = lambda h: drop(self.encoder_attn(
            h, enc, mode, attn_impl, cross_lens, cross_valid, cache, layer
        ))

        def ffn(h):
            h = copy_to_model(h, self.tp)
            cut = mlp_mode(remat)
            replay = shard_generator if live and self.activation_dropout else None
            if cut == "gelu":
                return drop(checkpoint_region(
                    self._ffn_tail, self.fc1(h), live, shard_generator, generator=replay))
            if cut == "mlp":
                return drop(checkpoint_region(self._ffn, h, live, shard_generator,
                                              generator=replay))
            return drop(self._ffn(h, live, shard_generator))

        if self.pre_norm:
            x = x + self_attn(self.self_attn_layer_norm(x))
            x = x + cross_attn(self.encoder_attn_layer_norm(x))
            return x + ffn(self.final_layer_norm(x))
        x = self.self_attn_layer_norm(x + self_attn(x))
        x = self.encoder_attn_layer_norm(x + cross_attn(x))
        return self.final_layer_norm(x + ffn(x))


class BartDecoder(nn.Module):
    """The decoder stack (HF ``model.decoder``)."""

    def __init__(self, cfg: BartDecoderCfg, kv_cache_dtype: str = "bf16"):
        super().__init__()
        D = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + cfg.pos_offset, D)
        if cfg.layernorm_embedding:
            self.layernorm_embedding = LayerNorm(D, cfg.ln_eps)
        self.layers = nn.ModuleList(
            BartDecoderLayer(cfg, kv_cache_dtype) for _ in range(cfg.decoder_layers)
        )
        if cfg.add_final_layer_norm:
            self.layer_norm = LayerNorm(D, cfg.ln_eps)


def _bias(valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, 0.0, NEG_MIN)


class BartCausalDecoder(nn.Module):
    """BART-style causal LM with cross-attention and a tied LM head
    (HF ``BartForCausalLM`` layout: ``model.decoder`` + ``lm_head``)."""

    def __init__(self, cfg: BartDecoderCfg, attn_impl: str = "xla", kv_cache_dtype: str = "bf16",
                 compute_dtype=None):
        super().__init__()
        if kv_cache_dtype not in DECODE_DTYPES:
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r} (one of {DECODE_DTYPES})")
        self.cfg = cfg
        self.attn_impl = attn_impl
        # dtype of the forward pass; None = the parameters' dtype
        self.compute_dtype = compute_dtype
        # source of the dropout masks in training mode (None = torch's default
        # generator); the train step reseeds it per (seed, step, micro-batch)
        self.dropout_generator: Optional[torch.Generator] = None
        # tensor parallelism (parallel/tensor_parallel.py): the rank holds
        # the tied table's rows [vocab_offset, vocab_offset + its rows);
        # the masks inside its own FFN columns come from
        # shard_dropout_generator (None: from dropout_generator)
        self.tp = None
        self.shard_dropout_generator: Optional[torch.Generator] = None
        self.vocab_offset = 0
        self.model = nn.ModuleDict({"decoder": BartDecoder(cfg, kv_cache_dtype)})
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.lm_head.weight = self.decoder.embed_tokens.weight  # tied

    @property
    def decoder(self) -> BartDecoder:
        return self.model["decoder"]

    def reseed_dropout(self, seed: int) -> None:
        """Point the dropout streams at ``seed`` (the train step's reseed):
        ``dropout_generator`` at it, under tensor parallelism a
        ``shard_dropout_generator`` on its device at the model rank's
        :func:`shard_seed` of it."""
        self.dropout_generator.manual_seed(seed)
        if self.tp is not None:
            if self.shard_dropout_generator is None:
                self.shard_dropout_generator = torch.Generator(
                    device=self.dropout_generator.device)
            self.shard_dropout_generator.manual_seed(shard_seed(seed, self.tp.rank))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """JAX init scheme: normal(0.02) dense kernels and embeddings, zero
        biases, unit LayerNorm."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _masks(self, mode, B, L, start, cache, device, attention_mask,
               key_pad_mask, encoder_pad_mask, Lk):
        """(self bias, self valid, cross kv_lens, cross valid) for this call,
        built once and shared by every layer. ``encoder_pad_mask`` reaches
        the cross-attention as per-sample lengths (no bias, so train mode
        keeps the flash kernel) and, from prefill on, as the decode kernel's
        ``cache.cross_mask``."""
        cross_lens = mask_lens(encoder_pad_mask)
        if mode == "train":
            self_bias = None
            if attention_mask is not None:
                self_bias = _bias(attention_mask[:, None, None, :].bool())
            return self_bias, None, cross_lens, None
        if mode == "prefill" or L > 1:
            T = cache.max_len
            col = torch.arange(T, device=device)
            q_pos = start + torch.arange(L, device=device)
            valid = col[None, None, None, :] <= q_pos[None, None, :, None]
            if key_pad_mask is not None:
                valid = valid & key_pad_mask[:, None, None, :].bool()
            if mode == "prefill":
                Lk_pad = _pad128(Lk)
                if encoder_pad_mask is not None:
                    cross = F.pad(encoder_pad_mask.bool(), (0, Lk_pad - Lk))
                else:
                    cross = (torch.arange(Lk_pad, device=device) < Lk).expand(B, Lk_pad)
                cache.cross_mask = cross.contiguous()
            return _bias(valid), None, cross_lens, None
        # single-token decode: boolean key masks for the decode kernel
        len_pad = _pad128(cache.max_len)
        valid = (torch.arange(len_pad, device=device) <= start)[None, :]
        if key_pad_mask is not None:
            valid = valid & F.pad(key_pad_mask.bool(), (0, len_pad - cache.max_len))
        return None, valid.expand(B, len_pad).contiguous(), None, cache.cross_mask

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, L)
        encoder_hidden_states: torch.Tensor,  # (B, Lk, D)
        attention_mask: Optional[torch.Tensor] = None,  # (B, L) 1 = attend (train)
        key_pad_mask: Optional[torch.Tensor] = None,  # (B, max_len) prefill/decode
        mode: str = "train",
        cache: Optional[KVCache] = None,
        return_hidden: bool = False,
        positions: Optional[torch.Tensor] = None,  # (B, L) explicit positions
        encoder_pad_mask: Optional[torch.Tensor] = None,  # (B, Lk) True = real key, real first
    ) -> torch.Tensor:
        """Logits ``(B, L, V)`` in fp32 (or the pre-head hidden states)."""
        cfg = self.cfg
        dec = self.decoder
        B, L = input_ids.shape
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"mode={mode!r} needs a KVCache")
        if mode == "prefill" and (cache.index or cache.self_k):
            raise ValueError("prefill needs a fresh KVCache")
        start = cache.index if mode != "train" else 0
        if positions is None:
            positions = start + torch.arange(L, device=input_ids.device)[None, :]

        dt = self.compute_dtype or dec.embed_tokens.weight.dtype
        x = vocab_parallel_embedding(input_ids, dec.embed_tokens.weight, self.tp,
                                     self.vocab_offset).to(dt)
        if cfg.scale_embedding:
            x = x * (cfg.d_model ** 0.5)
        x = x + dec.embed_positions(positions + cfg.pos_offset).to(dt)
        if cfg.layernorm_embedding:
            x = dec.layernorm_embedding(x)
        gen = self.dropout_generator
        x = dropout(x, cfg.dropout, self.training and mode == "train", gen)

        masks = self._masks(
            mode, B, L, start, cache, x.device, attention_mask, key_pad_mask,
            encoder_pad_mask, encoder_hidden_states.shape[1],
        )
        enc = encoder_hidden_states.to(x.dtype)
        for i, layer in enumerate(dec.layers):
            x = layer(x, enc, mode, self.attn_impl, masks, cache, i, gen,
                      self.shard_dropout_generator)
        if mode != "train":
            cache.index += L
        if cfg.add_final_layer_norm:
            x = dec.layer_norm(x)
        if return_hidden:
            return x
        # tied head in the compute dtype, logits surfaced in fp32
        return self.whole_logits(F.linear(x, self.lm_head.weight.to(x.dtype)).float())

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """``(B, L, V)`` logits from this rank's ``(B, L, Vl)`` vocabulary
        shard: under tensor parallelism gathered over ``model`` (no
        gradient; the same bits on every rank of the group, so every rank
        picks the same tokens), else ``logits`` as they are."""
        if self.tp is None:
            return logits
        layout = TPLayout(logits.dim() - 1, self.cfg.vocab_size)
        return gather_whole(logits, layout, self.tp)


# HF-name -> architecture table (facebook/bart-base & -large layouts), so the
# port never needs network access or the transformers lib at run time.
BART_ARCH_TABLE = {
    "facebook/bart-base": dict(
        vocab_size=50265, d_model=768, decoder_layers=6,
        decoder_attention_heads=12, decoder_ffn_dim=3072,
    ),
    "facebook/bart-large": dict(
        vocab_size=50265, d_model=1024, decoder_layers=12,
        decoder_attention_heads=16, decoder_ffn_dim=4096,
    ),
    # Donut decoder: mBART layout (pre-LN + final LN, scaled embeddings)
    "donut-mbart": dict(
        vocab_size=57525, d_model=1024, decoder_layers=4,
        decoder_attention_heads=16, decoder_ffn_dim=4096,
        pre_norm=True, add_final_layer_norm=True, scale_embedding=True,
    ),
    # test-size decoder, not an HF name
    "bart-test": dict(
        vocab_size=512, d_model=64, decoder_layers=2,
        decoder_attention_heads=2, decoder_ffn_dim=128,
    ),
}


def resolve_bart_cfg(
    name: str,
    num_decoder_layers: Optional[int] = None,
    max_length: Optional[int] = None,
    vocab_size: Optional[int] = None,
) -> BartDecoderCfg:
    """HF-style decoder name + overrides (decoder_layers,
    max_position_embeddings, vocab) -> BartDecoderCfg."""
    if name not in BART_ARCH_TABLE:
        raise ValueError(f"unknown text decoder '{name}' (known: {sorted(BART_ARCH_TABLE)})")
    arch = dict(BART_ARCH_TABLE[name])
    if num_decoder_layers is not None:
        arch["decoder_layers"] = num_decoder_layers
    if vocab_size is not None:
        arch["vocab_size"] = vocab_size
    kwargs = {}
    if max_length is not None:
        kwargs["max_position_embeddings"] = max_length
    return BartDecoderCfg(**arch, **kwargs)
