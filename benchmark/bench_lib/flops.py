"""Analytic matmul FLOPs of the Cruller models, from a configuration file's
sizes. The train step's count is the program's own arithmetic
(``framework/profiling.py``: ``transformer_layer_flops``,
``swin_encoder_flops``, ``cruller_train_flops``) copied here so that a
change to the program cannot move the yardstick. Its conventions are kept:
only matrix products count; causal self-attention counts its score and
value products over the full ``L x L``; the backward is twice the forward.

The eval count (:func:`eval_batch_flops`) follows the decode as it runs:
the encoder forward once a page, the cross-attention K/V projections once
a page, and for every position that the prefill or a decode step runs, the
decoder layers (self-attention over the positions so far, cross-attention
over the encoder rows) and the tied head.
"""

from __future__ import annotations

from typing import Dict, Sequence


def transformer_layer_flops(L: int, D: int, F: int, cross_Lk: int = 0) -> float:
    """Forward matmul FLOPs of one layer at length L (cross-attention over
    ``cross_Lk`` rows when it is > 0)."""
    self_attn = 8 * L * D * D + 4 * L * L * D
    ffn = 4 * L * D * F
    cross = 0.0
    if cross_Lk:
        cross = 4 * L * D * D + 4 * cross_Lk * D * D + 4 * L * cross_Lk * D
    return float(self_attn + ffn + cross)


def encoder_tokens(enc: Dict) -> int:
    """Rows the encoder hands the decoder."""
    if enc["kind"] == "swin":
        s = len(enc["depths"]) - 1
        p = enc["patch_size"] << s
        return (enc["image_size"][0] // p) * (enc["image_size"][1] // p)
    p = enc["patch_size"]
    n = (enc["image_size"][0] // p) * (enc["image_size"][1] // p)
    return n + int(enc.get("cls_token", True))


def swin_encoder_flops(enc: Dict) -> float:
    """Forward matmul FLOPs of a Swin encoder for one image: windowed
    attention (score and value products N * w^2), patch merging."""
    p = enc["patch_size"]
    gh, gw = enc["image_size"][0] // p, enc["image_size"][1] // p
    w2 = enc["window_size"] ** 2
    total = 2 * gh * gw * (p * p * enc["in_chans"]) * enc["embed_dim"]
    for stage, depth in enumerate(enc["depths"]):
        N = (gh >> stage) * (gw >> stage)
        D = enc["embed_dim"] << stage
        per_block = 8 * N * D * D + 4 * N * w2 * D + 4 * N * D * int(D * enc["mlp_ratio"])
        total += depth * per_block
        if stage < len(enc["depths"]) - 1:
            total += 2 * (N // 4) * (4 * D) * (2 * D)
    return float(total)


def encoder_flops(enc: Dict) -> float:
    """Forward matmul FLOPs of the encoder for one image."""
    if enc["kind"] == "swin":
        return swin_encoder_flops(enc)
    N, D, p = encoder_tokens(enc), enc["embed_dim"], enc["patch_size"]
    f = 2 * N * (p * p * enc["in_chans"]) * D
    return f + enc["depth"] * transformer_layer_flops(N, D, int(D * enc["mlp_ratio"]))


def train_step_flops(cfg: Dict, batch: int, text_len: int) -> float:
    """Matmul FLOPs of one forward and backward train step."""
    dec = cfg["decoder"]
    D = dec["d_model"]
    f = encoder_flops(cfg["encoder"])
    f += dec["layers"] * transformer_layer_flops(
        text_len, D, dec["ffn_dim"], cross_Lk=encoder_tokens(cfg["encoder"]))
    f += 2 * text_len * D * dec["vocab_size"]
    return 3.0 * batch * f


def eval_batch_flops(cfg: Dict, prompt_lens: Sequence[int], new_tokens: int) -> float:
    """Matmul FLOPs of one greedy batch: each page's encoder forward and
    cross K/V, its prompt's prefill and ``new_tokens - 1`` decode steps
    (the last token's step is not run), each position attending over the
    positions up to it."""
    dec = cfg["decoder"]
    D, F, V, layers = dec["d_model"], dec["ffn_dim"], dec["vocab_size"], dec["layers"]
    Lk = encoder_tokens(cfg["encoder"])
    per_page = encoder_flops(cfg["encoder"]) + layers * 4 * Lk * D * D
    total = 0.0
    for n in prompt_lens:
        positions = n + new_tokens - 1
        # per position: q,k,v,out (8D^2), cross q,out (4D^2), FFN (4DF), head (2DV),
        # cross scores and values (4 Lk D); self scores and values over t keys (4 t D)
        per_pos = layers * (12 * D * D + 4 * D * F + 4 * Lk * D) + 2 * D * V
        self_keys = positions * (positions + 1) / 2
        total += per_page + positions * per_pos + layers * 4 * D * self_keys
    return total
