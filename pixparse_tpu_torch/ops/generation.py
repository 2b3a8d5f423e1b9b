"""KV-cached greedy generation (counterpart of
:func:`pixparse_tpu.ops.generation.generate`).

One prefill pass caches the prompt's self-attention K/V and the encoder's
cross-attention K/V; then a Python loop runs one single-token decode step
per generated token. The output is a ``(B, max_length)`` token buffer in
which finished rows are padded. The loop ends when every row has produced
EOS (or used its ``max_new_tokens`` budget) or the buffer is full; the
last token's decode step, whose logits nobody reads, is not run.

With ``model.lm_head_dtype == 'int8'`` the decode steps apply the tied head
in int8, as the JAX package does: the ``(V, D)`` table is quantized per
vocabulary row once, before the loop; each step quantizes the hidden row
and takes an exact int32 product (``torch._int_mm``) scaled by both scales.
The prefill's logits use the table as it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.ops.decode_attention import quantize_int8_rows


def _left_align_prompts(prompt_ids: torch.Tensor, pad_token_id: int):
    """Right-padded variable-length prompts -> ``(aligned_prompt, positions,
    prompt_valid)``: every row's last real token lands in the final column,
    so generated tokens write contiguously and cache slots line up with
    buffer columns; explicit positions keep real-token positions
    pad-independent."""
    B, Lp = prompt_ids.shape
    prompt_valid = (prompt_ids != pad_token_id).sum(dim=1)  # (B,)
    col = torch.arange(Lp, device=prompt_ids.device)[None, :]
    src_idx = col - (Lp - prompt_valid)[:, None]
    aligned = torch.where(
        src_idx >= 0,
        torch.gather(prompt_ids, 1, src_idx.clamp(0, Lp - 1)),
        pad_token_id,
    )
    return aligned, src_idx.clamp_min(0), prompt_valid


def quantize_head(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(V, D)`` tied table -> ``(table_i8 (V8, D), row scales (V,) fp32)``,
    V padded with zero rows to a multiple of 8 (``torch._int_mm``'s rule on
    the card)."""
    table_i8, scales = quantize_int8_rows(table.float(), 1)
    return F.pad(table_i8, (0, 0, 0, -table.shape[0] % 8)), scales[:, 0]


def q8_logits(hidden: torch.Tensor, table_i8: torch.Tensor, row_scales: torch.Tensor):
    """``(B, L, D)`` hidden states -> ``(B, L, V)`` fp32 logits of the int8
    head: ``int32(x_i8 . table_i8) * x_scale * row_scale``. The rows are
    padded to a multiple of 8 above 16 for ``torch._int_mm`` on the card
    (D must be a multiple of 8)."""
    B, L, D = hidden.shape
    x_i8, x_scale = quantize_int8_rows(hidden.float(), -1)
    M = B * L
    x_i8 = F.pad(x_i8.reshape(M, D), (0, 0, 0, max(24, -(-M // 8) * 8) - M))
    raw = torch._int_mm(x_i8, table_i8.t())[:M, : row_scales.shape[0]]
    return (raw.float().reshape(B, L, -1) * x_scale) * row_scales


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_length) int64, pad-filled after EOS
    lengths: torch.Tensor  # (B,) valid tokens (prompt + generated + eos)
    steps: int = 0  # decode steps run after the prefill


@torch.inference_mode()
def generate(
    model,  # Cruller (anything with .decode(ids, enc, cache, ...))
    encoder_output: torch.Tensor,  # (B, Lk, D)
    prompt_ids: torch.Tensor,  # (B, Lp); may contain pad (masked out)
    *,
    max_length: int,
    eos_token_id: int,
    pad_token_id: int,
    encoder_pad_mask: Optional[torch.Tensor] = None,  # (B, Lk) True = real key
    max_new_tokens: Optional[torch.Tensor] = None,  # (B,) per-row budget (>= 1)
) -> GenerateResult:
    """Greedy KV-cached decode; tokens are identical to the JAX package's
    ``generate`` for the same weights and inputs (up to float ties)."""
    B, Lp = prompt_ids.shape
    if Lp >= max_length:
        raise ValueError(f"prompt length {Lp} >= max_length {max_length}")
    device = encoder_output.device
    prompt_ids = prompt_ids.to(device=device, dtype=torch.long)
    aligned, positions, prompt_valid = _left_align_prompts(prompt_ids, pad_token_id)
    if max_new_tokens is not None:
        max_new_tokens = torch.as_tensor(max_new_tokens, device=device)

    head_i8 = None
    if getattr(model, "lm_head_dtype", "bf16") == "int8":
        head_i8 = quantize_head(model.tied_embedding)

    buffer = torch.full((B, max_length), pad_token_id, dtype=torch.long, device=device)
    buffer[:, :Lp] = aligned
    cache = KVCache(max_len=max_length)
    logits = model.decode(
        aligned, encoder_output, cache, key_pad_mask=buffer != pad_token_id,
        mode="prefill", positions=positions, encoder_pad_mask=encoder_pad_mask,
    )[:, -1]

    finished = torch.zeros(B, dtype=torch.bool, device=device)
    steps = 0
    for cur in range(Lp, max_length):
        next_tok = logits.argmax(dim=-1)
        newly_finished = finished | (next_tok == eos_token_id)
        if max_new_tokens is not None:
            # rows share the column clock (left-aligned prompts)
            newly_finished |= (cur - Lp + 1) >= max_new_tokens
        write_tok = torch.where(finished, pad_token_id, next_tok)
        buffer[:, cur] = write_tok
        finished = newly_finished
        if cur + 1 >= max_length or bool(finished.all()):
            break
        out = model.decode(
            write_tok[:, None], encoder_output, cache,
            key_pad_mask=buffer != pad_token_id, mode="decode",
            positions=(prompt_valid + (cur - Lp))[:, None],
            encoder_pad_mask=encoder_pad_mask, return_hidden=head_i8 is not None,
        )
        logits = (out if head_i8 is None else q8_logits(out, *head_i8))[:, -1]
        steps += 1
    lengths = (buffer != pad_token_id).sum(dim=1)
    return GenerateResult(tokens=buffer, lengths=lengths, steps=steps)
