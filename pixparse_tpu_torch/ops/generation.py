"""KV-cached generation (counterpart of :mod:`pixparse_tpu.ops.generation`):
greedy or temperature-sampled :func:`generate`, :func:`generate_beam`, and
the cache-free :func:`generate_naive` oracle.

One prefill pass caches the prompt's self-attention K/V and the encoder's
cross-attention K/V; then a Python loop runs one single-token decode step
per generated token. The output is a ``(B, max_length)`` token buffer in
which finished rows are padded. The loop ends when every row has produced
EOS (or used its ``max_new_tokens`` budget) or the buffer is full; the
last token's decode step, whose logits nobody reads, is not run.

``generate(sample=True)`` draws each token from ``softmax(logits /
temperature)`` (fp32) with an explicit ``torch.Generator`` on the tensors'
device; the draws cannot equal JAX's, only their distribution can.

With ``model.lm_head_dtype == 'int8'`` the decode steps of :func:`generate`
apply the tied head in int8, as the JAX package does: the ``(V, D)`` table
is quantized per vocabulary row once, before the loop; each step quantizes
the hidden row and takes an exact int32 product (``torch._int_mm``) scaled
by both scales. The prefill's logits use the table as it is. Beam search
always uses the exact tied head (the int8 cross caches still apply).

A model cut over the mesh's ``model`` axis
(:mod:`pixparse_tpu_torch.parallel.tensor_parallel`) runs unchanged: its
caches hold the rank's heads, and its logits come gathered whole over the
vocabulary shards (the int8 head quantizes the rank's rows, whose scales
are per row, and gathers its logits), bitwise equal on every rank of the
group, so greedy, beam and sampled tokens (the default generator is
seeded alike) are the same on every rank.
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


def select_next(logits: torch.Tensor, sample: bool = False, temperature: float = 5.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``(B, V)`` logits -> ``(B,)`` next tokens: the argmax (the first of
    equal maxima), or one draw per row from ``softmax(logits / temperature)``
    in fp32 with ``generator``."""
    if not sample:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
    sample: bool = False,
    temperature: float = 5.0,
    generator: Optional[torch.Generator] = None,  # on the tensors' device
) -> GenerateResult:
    """KV-cached decode. Greedy: tokens identical to the JAX package's
    ``generate`` for the same weights and inputs (up to float ties).
    ``sample``: each token drawn from ``softmax(logits / temperature)``
    with ``generator`` (default: a generator on the device seeded with 0,
    as JAX's default key is ``PRNGKey(0)``)."""
    B, Lp = prompt_ids.shape
    if Lp >= max_length:
        raise ValueError(f"prompt length {Lp} >= max_length {max_length}")
    device = encoder_output.device
    prompt_ids = prompt_ids.to(device=device, dtype=torch.long)
    aligned, positions, prompt_valid = _left_align_prompts(prompt_ids, pad_token_id)
    if max_new_tokens is not None:
        max_new_tokens = torch.as_tensor(max_new_tokens, device=device)
    if sample and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

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
        next_tok = select_next(logits, sample, temperature, generator)
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
        if head_i8 is not None:  # this rank's vocabulary rows, then the whole row
            out = model.decoder.whole_logits(q8_logits(out, *head_i8))
        logits = out[:, -1]
        steps += 1
    lengths = (buffer != pad_token_id).sum(dim=1)
    return GenerateResult(tokens=buffer, lengths=lengths, steps=steps)


@torch.inference_mode()
def generate_naive(
    model,
    encoder_output: torch.Tensor,  # (B, Lk, D)
    prompt_ids: torch.Tensor,  # (B, Lp); right-padded, NOT left-aligned
    *,
    max_length: int,
    eos_token_id: int,
    pad_token_id: int,
) -> torch.Tensor:
    """The reference algorithm's greedy decode, the tests' oracle (JAX
    ``generate_naive``): every step a cache-free ``mode='train'`` pass over
    the whole prefix, the next token from each row's last non-pad
    position; tokens after EOS are pad. Returns ``(B, max_length)``. An
    all-true key mask is passed as none (the same scores), so on the card
    the pass runs the flash kernels."""
    device = encoder_output.device
    ids = prompt_ids.to(device=device, dtype=torch.long)
    B = ids.shape[0]
    rows = torch.arange(B, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    while ids.shape[1] < max_length and not bool(finished.all()):
        mask = ids != pad_token_id
        logits = model.decode(
            ids, encoder_output, mode="train", attention_mask=None if bool(mask.all()) else mask,
        )
        last = (mask.sum(dim=1) - 1).clamp_min(0)
        next_tok = logits[rows, last].argmax(dim=-1)
        write = torch.where(finished, pad_token_id, next_tok)
        finished = finished | (next_tok == eos_token_id)
        ids = torch.cat([ids, write[:, None]], dim=1)
    return F.pad(ids, (0, max_length - ids.shape[1]), value=pad_token_id)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

class BeamResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_length) best beam, pad-filled after EOS
    scores: torch.Tensor  # (B,) length-normalized log-prob of the best beam
    all_tokens: torch.Tensor  # (B, K, max_length)
    all_scores: torch.Tensor  # (B, K)
    steps: int = 0  # decode steps run after the prefill


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest in descending
    order, equal values by ascending index. A stable sort, because
    ``torch.topk`` leaves the order of equal values open. With ``V >= K``
    no ``-inf`` entry (a dead beam at the start, a frozen beam's other
    tokens) reaches the top ``k``, as at least ``V`` entries are finite;
    equal finite log-probs (equal logits) are rare, but where they occur
    they decide which beam holds which position."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@torch.inference_mode()
def generate_beam(
    model,
    encoder_output: torch.Tensor,  # (B, Lk, D)
    prompt_ids: torch.Tensor,  # (B, Lp), the layout generate() takes
    *,
    num_beams: int,
    max_length: int,
    eos_token_id: int,
    pad_token_id: int,
    length_penalty: float = 1.0,
) -> BeamResult:
    """KV-cached beam search, step for step the JAX package's
    ``generate_beam``: additive fp32 log-probs; only beam 0 of a sample
    live at the start; finished beams frozen (pad at score 0, every other
    token ``-inf``); the top ``K`` of ``K * V`` per sample, source beam
    ``// V`` and token ``% V``; lengths counted with EOS; the final ranking
    by ``score / max(length, 1) ** length_penalty``. ``num_beams=1`` gives
    the greedy tokens.

    Beam search applies the exact tied head even when ``lm_head_dtype ==
    'int8'`` (int8 noise would reorder candidates whose log-probs are
    compared); the int8 cross caches still apply. No ``encoder_pad_mask``,
    no ``max_new_tokens``, as in JAX.

    The prefill runs once per sample; its caches and logits are repeated
    for the sample's beams (the same values as a prefill of ``K`` equal
    rows). Each decode step gathers the self caches' written prefix by
    source beam (:meth:`KVCache.reorder`) and runs on ``B * K`` rows."""
    B, Lp = prompt_ids.shape
    K = num_beams
    if Lp >= max_length:
        raise ValueError(f"prompt length {Lp} >= max_length {max_length}")
    if K < 1:
        raise ValueError(f"num_beams={K}")
    device = encoder_output.device
    prompt_ids = prompt_ids.to(device=device, dtype=torch.long)
    aligned, positions, prompt_valid = _left_align_prompts(prompt_ids, pad_token_id)

    buffer = torch.full((B, max_length), pad_token_id, dtype=torch.long, device=device)
    buffer[:, :Lp] = aligned
    cache = KVCache(max_len=max_length)
    logits = model.decode(
        aligned, encoder_output, cache, key_pad_mask=buffer != pad_token_id,
        mode="prefill", positions=positions,
    )[:, -1].repeat_interleave(K, dim=0)
    cache.repeat_rows(K)
    buffer = buffer.repeat_interleave(K, dim=0)
    valid = prompt_valid.repeat_interleave(K)
    V = logits.shape[-1]

    scores = torch.full((B, K), float("-inf"), device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros(B * K, dtype=torch.bool, device=device)
    lengths = torch.zeros(B * K, dtype=torch.long, device=device)
    first_row = (torch.arange(B, device=device) * K)[:, None]
    pad_row = torch.full((V,), float("-inf"), device=device)
    pad_row[pad_token_id] = 0.0
    steps = 0
    for cur in range(Lp, max_length):
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        logprobs = torch.where(finished[:, None], pad_row, logprobs)
        total = (scores.reshape(B * K, 1) + logprobs).reshape(B, K * V)
        scores, top_flat = top_k(total, K)
        src = (first_row + top_flat // V).reshape(-1)  # flat source rows
        token = (top_flat % V).reshape(-1)
        buffer = buffer[src]
        finished = finished[src]
        lengths = torch.where(finished, lengths[src], lengths[src] + 1)
        valid = valid[src]
        write_tok = torch.where(finished, pad_token_id, token)
        buffer[:, cur] = write_tok
        finished = finished | (token == eos_token_id)
        if cur + 1 >= max_length or bool(finished.all()):
            break
        cache.reorder(src)
        # a single-token step reads the cross caches only: the per-sample
        # encoder output gives just the encoder length
        logits = model.decode(
            write_tok[:, None], encoder_output, cache, key_pad_mask=buffer != pad_token_id,
            mode="decode", positions=(valid + (cur - Lp))[:, None],
        )[:, -1]
        steps += 1

    norm = scores / lengths.reshape(B, K).clamp_min(1).float() ** length_penalty
    best = norm.argmax(dim=1)
    all_tokens = buffer.reshape(B, K, max_length)
    rows = torch.arange(B, device=device)
    return BeamResult(
        tokens=all_tokens[rows, best], scores=norm[rows, best],
        all_tokens=all_tokens, all_scores=norm, steps=steps,
    )
