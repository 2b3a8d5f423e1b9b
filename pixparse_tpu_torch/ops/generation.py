"""KV-cached greedy generation (counterpart of
:func:`pixparse_tpu.ops.generation.generate`).

One prefill pass caches the prompt's self-attention K/V and the encoder's
cross-attention K/V; then a Python loop runs one single-token decode step
per generated token. The output is a ``(B, max_length)`` token buffer in
which finished rows are padded. The loop ends when every row has produced
EOS (or used its ``max_new_tokens`` budget) or the buffer is full; the
last token's decode step, whose logits nobody reads, is not run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pixparse_tpu_torch.models.bart import KVCache


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
        logits = model.decode(
            write_tok[:, None], encoder_output, cache,
            key_pad_mask=buffer != pad_token_id, mode="decode",
            positions=(prompt_valid + (cur - Lp))[:, None],
            encoder_pad_mask=encoder_pad_mask,
        )[:, -1]
        steps += 1
    lengths = (buffer != pad_token_id).sum(dim=1)
    return GenerateResult(tokens=buffer, lengths=lengths, steps=steps)
