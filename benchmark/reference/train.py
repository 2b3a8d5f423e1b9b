"""The reference train steps: the model of :mod:`reference.model` in
float32, the pretraining loss (mean cross entropy over the valid targets of
the shifted rows) and AdamW in optax's order, from the published
algorithm:

    u = m_hat / (sqrt(v_hat) + eps) + weight_decay * p   (decayed leaves)
    p <- p - lr(count before the update) * u

with a linear warm-up from ``warmup_learning_rate`` to ``learning_rate``
over ``num_warmup_intervals * updates_per_interval`` updates, then a cosine
to 0 over the rest of ``num_intervals * updates_per_interval``. Weight
decay applies to every leaf of two or more dimensions except position
tables of the encoder (``pos_embed``) and the class token.

Dropout follows the train step's streams: the masks of step ``k`` come
from a generator seeded with :func:`dropout_seed` of the dropout base seed
(``seed + 1`` of the seed the train state was made with), ``k`` and the
micro-batch 0. The batch runs in chunks of rows whose gradients add up to
the whole batch's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference.model import Cruller, Dropout
from reference.numerics import Numerics

IGNORE = -100
M64 = (1 << 64) - 1


def dropout_seed(seed: int, step: int, micro_idx: int = 0, rank: int = 0) -> int:
    """The dropout stream's seed of one micro-batch of one step."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro_idx * 0x94D049BB133111EB
         + rank * 0xD1B54A32D192ED03) & M64
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & M64
    x ^= x >> 32
    return x & ((1 << 63) - 1)


def learning_rate(opt: Dict, count: int) -> float:
    upi = opt["updates_per_interval"]
    warm = max(0, opt["num_warmup_intervals"] * upi)
    total = max(1, opt["num_intervals"] * upi)
    decay = max(1, total - warm)
    lr, lr0 = opt["learning_rate"], opt.get("warmup_learning_rate", 0.0)
    if count < warm:
        return lr0 + (lr - lr0) * count / warm
    c = min(count - warm, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * c / decay))


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 and not name.endswith(("pos_embed", "cls_token"))


class AdamW:
    def __init__(self, opt: Dict, params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.b1, self.b2 = opt.get("betas") or (0.9, 0.999)
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = learning_rate(self.opt, self.count)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, p in params.items():
            g = grads[n]
            self.mu[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[n].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (self.mu[n] / c1) / ((self.nu[n] / c2).sqrt() + self.opt["eps"])
            if self.opt["weight_decay"] and decays(n, p):
                u = u + self.opt["weight_decay"] * p
            p.add_(u, alpha=-lr)


def step_loss_and_grads(model: Cruller, num: Numerics, batch: Dict, dropout_gen,
                        chunk_rows: int, device) -> torch.Tensor:
    """One step's loss; the gradients are left in ``.grad``. ``batch``:
    numpy ``image`` (B, H, W, C) and unshifted ``text`` / ``target``."""
    dec = model.decoder.c
    text = torch.as_tensor(batch["text"][:, :-1], device=device)
    target = torch.as_tensor(batch["target"][:, 1:], device=device)
    images = batch["image"]
    B, L = text.shape
    drops = Dropout(dec["dropout"], dec["activation_dropout"], dropout_gen)
    drops.draw_step(B, L, dec["d_model"], dec["ffn_dim"], dec["layers"])
    n_valid = (target != IGNORE).sum().clamp_min(1).float()
    positions = torch.arange(L, device=device)[None]
    total = torch.zeros((), device=device)
    for r0 in range(0, B, chunk_rows):
        rows = slice(r0, min(B, r0 + chunk_rows))
        img = torch.as_tensor(images[rows], device=device, dtype=torch.float32)
        enc = model.encoder.run(num, img)
        ids = text[rows]
        h = model.decoder.hidden(num, ids, enc, positions.expand_as(ids), iter(drops.masks), rows)
        logits = model.decoder.logits(num, h)
        nll = F.cross_entropy(logits.flatten(0, 1), target[rows].flatten(),
                              ignore_index=IGNORE, reduction="sum")
        (nll / n_valid).backward()
        total += nll.detach()
        del logits, h, enc
    return total / n_valid


def train_readings(model: Cruller, num: Numerics, batches: Sequence[Dict], opt: Dict,
                   dropout_base: int, chunk_rows: int, device) -> Dict:
    """Run ``len(batches)`` steps: each step's loss, the first gradient's
    norm per leaf and the change of every leaf after the last step."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    adam = AdamW(opt, params)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for k, batch in enumerate(batches):
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(dropout_base, k))
        for p in params.values():
            p.grad = None
        loss = step_loss_and_grads(model, num, batch, gen, chunk_rows, device)
        losses.append(float(loss))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        if k == 0:
            norms = torch._foreach_norm(list(grads.values()))
            grad_norms = {n: float(v) for n, v in zip(grads, norms)}
        adam.step(params, grads)
    with torch.no_grad():
        deltas = torch._foreach_norm([p - start[n] for n, p in params.items()])
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": {n: float(v) for n, v in zip(params, deltas)}}
