"""Continuous-batching greedy decode for serving (counterpart of
:mod:`pixparse_tpu.ops.serving`).

Batch decode (:func:`~pixparse_tpu_torch.ops.generation.generate`) runs
every page of a batch until its slowest page finishes. Here ``B`` decode
slots persist, and a slot whose page finished takes the next page of the
stream, so the decode batch stays full while the page lengths vary.

Semantics kept from the JAX package:

- **pool staging**: pages are encoded ``refill_size`` at a time into pool
  groups of ``G`` pages, each prefilled in one batched
  ``model.decode(..., mode='prefill')``; a pool keeps each page's cross
  caches whole, its self caches cut to the prompt block, its first logits
  and its budget. The next group is staged while the current one is drained;
- **one shared cache column**: slot caches have ``C`` self-attention
  columns and one write column ``cache.index``. A refill writes the page's
  prompt block at ``[col, col + Lp)`` and advances the column by ``Lp``;
  each decode step writes one column. A per-slot ``(B, C)`` mask, the
  decoder's ``key_pad_mask``, marks a slot's own columns (a band that starts
  where the slot was refilled), and positions restart at the prompt's valid
  length, so a page's tokens do not depend on its neighbours or its slot;
- **compaction** when ``col + Lp + 2 > C``: every row's own columns are
  gathered to the left (:meth:`KVCache.compact`) and the column restarts at
  ``max_length``;
- at most ``Rm`` refills a step; per-page budgets and the ``max_length``
  cap; results as ``prompt + generated (+ EOS)``, in completion order.

Left out, as TPU structure: the branch-free device loop, the idempotent
self-writes of inactive refill entries, the results ring and its host read
floor, all there to avoid round trips over a remote-TPU transport. Here the
host drives each step, as ``generate`` does: one small device-to-host read
a step (the finished flags), and one read of a finished row's tokens when
its slot is refilled or at the end.

On a CUDA model every decode step runs the decode kernel over the self
caches and the bf16 (or int8) decode kernel over the cross caches; the
encode runs the flash kernels. With ``lm_head_dtype == 'int8'`` the decode
steps apply the int8 tied head, as ``generate`` does (the JAX batcher
applies the exact head there).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pixparse_tpu_torch.models.bart import KVCache, _pad128
from pixparse_tpu_torch.ops.generation import _left_align_prompts, q8_logits, quantize_head


class PageResult(NamedTuple):
    page_id: Any
    tokens: np.ndarray  # (length,) prompt + generated (incl. EOS)
    length: int


class _Pool(NamedTuple):
    """One staged pool group: ``n`` prefilled pages."""

    cache: KVCache  # cross caches whole, self caches cut to the prompt block
    logits: torch.Tensor  # (n, V) fp32: each page's first next-token logits
    budgets: torch.Tensor  # (n,) generation budgets
    page_ids: List[Any]
    enc_shape: Tuple[int, int]  # the encoder output's (Lk, D)


class ContinuousBatcher:
    """Decode a stream of page images with slot refill (greedy).

    Args:
      model: a ``Cruller`` (``encode``/``decode``), on its device.
      slots: persistent decode batch ``B``.
      max_length: per-page token budget (prompt + generated), as in
        ``generate``.
      prompt_ids: ``(Lp,)`` prompt shared by every page.
      eos_token_id / pad_token_id: as in ``generate``.
      refill_size: pages per ``encode_fn`` call when staging a pool.
      chunk_steps: accepted and unused, as in the JAX package (refill is
        per step).
      capacity_slack: self-cache columns beyond ``max_length``; when it runs
        out, a compaction. Default: ``C`` = the larger of ``2 * max_length``
        and ``max_length + 32 * (Lp + 1)``, rounded up to 128.
      pool_pages: pages per pool group (default ``2 * slots``, rounded up
        to a multiple of ``refill_size``).
      max_refill_per_step: slots refilled per decode step (default
        ``min(slots, 2)``).

    After :meth:`run`, ``steps``, ``refills`` and ``compactions`` count its
    decode steps, slot refills and compactions.
    """

    def __init__(
        self,
        model,
        *,
        slots: int,
        max_length: int,
        prompt_ids,
        eos_token_id: int,
        pad_token_id: int,
        refill_size: int = 8,
        chunk_steps: int = 16,
        capacity_slack: Optional[int] = None,
        pool_pages: Optional[int] = None,
        max_refill_per_step: Optional[int] = None,
    ):
        del chunk_steps  # compat: refill is per step
        self.model = model
        self.B = int(slots)
        self.max_length = int(max_length)
        self.eos = int(eos_token_id)
        self.pad = int(pad_token_id)
        self.E = min(int(refill_size), self.B)
        pid = np.asarray(prompt_ids, np.int64).reshape(-1)
        self.Lp = int(pid.shape[0])
        if self.Lp >= self.max_length:
            raise ValueError(f"prompt length {self.Lp} >= max_length {self.max_length}")
        if capacity_slack is None:
            c = max(2 * self.max_length, self.max_length + 32 * (self.Lp + 1))
            self.C = -(-c // 128) * 128
        else:  # honoured exactly; at least one refill and a step
            self.C = self.max_length + max(int(capacity_slack), self.Lp + 4)
        g = int(pool_pages) if pool_pages else 2 * self.B
        self.G = max(self.E, -(-g // self.E) * self.E)
        self.Rm = (min(self.B, 2) if max_refill_per_step is None
                   else max(1, min(int(max_refill_per_step), self.B)))
        real = pid[pid != self.pad]
        self.prompt_valid = int(real.shape[0])
        self._prompt_row = np.full((self.max_length,), self.pad, np.int64)
        self._prompt_row[: self.prompt_valid] = real
        self.prompt_ids = pid
        self.steps = self.refills = self.compactions = 0

    # ------------------------------------------------------------------
    def _stage(self, group, encode_fn, max_new_tokens) -> Optional[_Pool]:
        """Encode ``group`` ``refill_size`` pages at a time and prefill it in
        one batch; the self caches are cut to the prompt block."""
        if not group:
            return None
        encs = [encode_fn(np.stack([np.asarray(img) for _, img in group[lo:lo + self.E]]))
                for lo in range(0, len(group), self.E)]
        enc = torch.cat(encs) if len(encs) > 1 else encs[0]
        n, device = enc.shape[0], enc.device
        prompts = torch.as_tensor(self.prompt_ids, device=device).expand(n, self.Lp)
        aligned, positions, valid = _left_align_prompts(prompts, self.pad)
        cache = KVCache(max_len=self.C)
        key_mask = torch.arange(self.C, device=device)[None, :] < valid[:, None]
        logits = self.model.decode(aligned, enc, cache, key_pad_mask=key_mask, mode="prefill",
                                   positions=positions)[:, -1].float()
        cache.self_k[:] = [c[:, : self.Lp].clone() for c in cache.self_k]
        cache.self_v[:] = [c[:, : self.Lp].clone() for c in cache.self_v]
        budgets = [max(1, int(max_new_tokens(p) if max_new_tokens else self.max_length))
                   for p, _ in group]
        return _Pool(cache, logits, torch.tensor(budgets, device=device), [p for p, _ in group],
                     tuple(enc.shape[1:]))

    def _slot_cache(self, pool: KVCache) -> KVCache:
        """Empty slot caches of the pool's layout: ``B`` rows, ``C`` self
        columns (padded to 128), no live key."""
        B, len_pad = self.B, _pad128(self.C)
        rows = lambda ts, fill: [t.new_full((B,) + t.shape[1:], fill) for t in ts]
        return KVCache(
            max_len=self.C,
            self_k=[t.new_zeros(B, len_pad, t.shape[2]) for t in pool.self_k],
            self_v=[t.new_zeros(B, len_pad, t.shape[2]) for t in pool.self_v],
            cross_k=rows(pool.cross_k, 0), cross_v=rows(pool.cross_v, 0),
            cross_k_scale=rows(pool.cross_k_scale, 1), cross_v_scale=rows(pool.cross_v_scale, 1),
            qkv=pool.qkv, cross_mask=pool.cross_mask.new_zeros(B, pool.cross_mask.shape[1]),
        )

    @torch.inference_mode()
    def run(
        self,
        pages: Iterable[Tuple[Any, np.ndarray]],
        encode_fn: Callable[[np.ndarray], torch.Tensor],
        *,
        max_new_tokens: Optional[Callable[[Any], int]] = None,
    ) -> Iterator[PageResult]:
        """Decode a stream of ``(page_id, image)`` pairs; yields
        :class:`PageResult` in completion order. ``encode_fn`` maps an
        ``(n, H, W, C)`` image batch (``n <= refill_size``) to the encoder
        output ``(n, Lk, D)`` on the model's device. ``max_new_tokens``:
        optional per-page budget (page_id -> int >= 1; default the
        ``max_length`` cap)."""
        B, Lp, C = self.B, self.Lp, self.C
        self.steps = self.refills = self.compactions = 0
        it = iter(pages)

        def take(n):
            return [page for _, page in zip(range(n), it)]

        stage = lambda: self._stage(take(self.G), encode_fn, max_new_tokens)
        pools = deque(p for p in (stage(), stage()) if p is not None)
        if not pools:
            return
        device = pools[0].logits.device
        encs_shape = pools[0].enc_shape
        cache = self._slot_cache(pools[0].cache)
        head_i8 = (quantize_head(self.model.tied_embedding)
                   if getattr(self.model, "lm_head_dtype", "bf16") == "int8" else None)
        V = pools[0].logits.shape[1]
        buffer = torch.full((B, self.max_length), self.pad, dtype=torch.long, device=device)
        cache_mask = torch.zeros(B, C, dtype=torch.bool, device=device)
        tok_count = torch.zeros(B, dtype=torch.long, device=device)
        finished = torch.ones(B, dtype=torch.bool, device=device)
        logits = torch.zeros(B, V, device=device)
        max_new = torch.zeros(B, dtype=torch.long, device=device)
        prompt_row = torch.as_tensor(self._prompt_row, device=device)
        pv = self.prompt_valid  # every page's prompt: the shared one
        cols = torch.arange(C, device=device)
        # the slots' encoder input: a decode step reads only its shape, so a
        # broadcast scalar in the decoder's dtype (no copy per step)
        dt = self.model.decoder.compute_dtype or self.model.tied_embedding.dtype
        dummy_enc = torch.zeros((), dtype=dt, device=device).expand(B, *encs_shape)

        slot_page: List[Any] = [None] * B  # page id, or None: no page
        done_at = [0] * B  # the step its page finished at
        idle = [True] * B  # host copy of ``finished``
        pool_next = 0
        col = 0

        def results(slots):
            """The pages of finished ``slots``, read in one transfer, in
            completion order."""
            slots = sorted((s for s in slots if slot_page[s] is not None),
                           key=lambda s: (done_at[s], s))
            if not slots:
                return []
            idx = torch.tensor(slots, device=device)
            host = torch.cat([tok_count[idx, None], buffer[idx]], dim=1).cpu().numpy()
            out = []
            for s, row in zip(slots, host):
                n = int(row[0])
                out.append(PageResult(slot_page[s], row[1:1 + n].copy(), n))
                slot_page[s] = None
            return out

        while True:
            if col + Lp + 2 > C:
                cache_mask = cache.compact(cache_mask)
                col = self.max_length
                self.compactions += 1
            while pools and pool_next >= len(pools[0].page_ids):
                pools.popleft()
                pool_next = 0
                nxt = stage()
                if nxt is not None:
                    pools.append(nxt)
            free = [s for s in range(B) if idle[s]]
            n_take = min(len(free), self.Rm, len(pools[0].page_ids) - pool_next) if pools else 0
            if n_take:
                taken = free[:n_take]
                yield from results(taken)
                pool = pools[0]
                rows = torch.tensor(taken, device=device)
                src = torch.arange(pool_next, pool_next + n_take, device=device)
                cache.splice_rows(rows, pool.cache, src)
                cache.splice_prompt(rows, pool.cache, src, col, Lp)
                buffer[rows] = prompt_row
                cache_mask[rows] = ((cols >= col) & (cols < col + pv))[None]
                tok_count[rows] = pv
                finished[rows] = False
                logits[rows] = pool.logits[src]
                max_new[rows] = pool.budgets[src]
                for s, p in zip(taken, pool.page_ids[pool_next:pool_next + n_take]):
                    slot_page[s], idle[s] = p, False
                pool_next += n_take
                col += Lp
                self.refills += n_take
            elif all(idle):
                yield from results(range(B))
                return

            # one greedy step over every slot (generate()'s body, per row)
            tok = logits.argmax(dim=-1)
            live = ~finished
            newly = (finished | (tok == self.eos)
                     | (tok_count - pv + 1 >= max_new)
                     | (tok_count + 1 >= self.max_length))
            write = torch.where(finished, self.pad, tok)
            # the token's column and position; a finished row's count may
            # reach max_length: clamped, as its step's output is never read
            at = tok_count.clamp_max(self.max_length - 1)[:, None]
            buffer.scatter_(1, at, torch.where(live[:, None], write[:, None], buffer.gather(1, at)))
            # a generated pad token is no key, as in generate()'s pad mask
            cache_mask[:, col] |= live & (write != self.pad)
            cache.index = col
            out = self.model.decode(
                write[:, None], dummy_enc, cache, key_pad_mask=cache_mask, mode="decode",
                positions=at, return_hidden=head_i8 is not None,
            )
            logits = (out if head_i8 is None else q8_logits(out, *head_i8))[:, -1]
            tok_count += live
            finished = newly
            col += 1
            self.steps += 1
            for s, f in enumerate(finished.tolist()):  # the step's one read
                if f and not idle[s]:
                    idle[s], done_at[s] = True, self.steps
