"""The least time the card could take for a kernel's call: the larger of
its needed operations over the peak FLOP/s and its bytes over the peak
bandwidth. Operations count what the inputs need (visible pairs under a
causal mask, valid keys, valid targets), bytes count each input read once
and each output written once. The formulas are the port's kernel bounds
(``PERF.md`` "Bounds"), copied so that the program cannot move them.

Each function returns ``(flops, bytes)`` for one call; :func:`seconds`
turns a list of them into the bound.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

Work = Tuple[float, float]


def visible_pairs(B: int, Lq: int, Lk: int, causal: bool,
                  lens: Optional[Sequence[int]] = None) -> Tuple[int, list]:
    """(query, key) pairs the masks leave, and the valid keys per sample."""
    kl = [min(n, Lk) for n in (lens or [Lk] * B)]
    pairs = 0
    for n in kl:
        if causal:
            off = Lk - Lq
            # sum over rows i of min(n, i + off + 1), clipped at 0
            pairs += sum(max(0, min(n, i + off + 1)) for i in range(Lq))
        else:
            pairs += Lq * n
    return pairs, kl


def flash_fwd(B, Lq, Lk, H, D, causal, lens=None, elt=2) -> Work:
    pairs, kl = visible_pairs(B, Lq, Lk, causal, lens)
    flops = 4.0 * H * D * pairs  # q k^T and p v
    nbytes = elt * H * D * (2 * B * Lq + 2 * sum(kl)) + 4 * B * H * Lq  # q, o; k, v; lse
    return flops, nbytes


def flash_bwd(B, Lq, Lk, H, D, causal, lens=None, elt=2) -> Work:
    pairs, kl = visible_pairs(B, Lq, Lk, causal, lens)
    flops = 10.0 * H * D * pairs  # s, dp, dv, dq, dk: five products
    nbytes = elt * H * D * (3 * B * Lq + 2 * sum(kl) + 2 * B * Lk) + 8 * B * H * Lq
    return flops, nbytes


def fused_ce_fwd(T: int, V: int, D: int, elt=2) -> Work:
    """``T`` valid target rows over a ``(V, D)`` table."""
    return 2.0 * T * V * D, elt * D * (T + V) + 12 * T


def fused_ce_bwd(T: int, V: int, D: int, elt=2) -> Work:
    return 6.0 * T * V * D, 2 * elt * D * (T + V) + 12 * T  # logits again, dh, dE


def window_fwd(nB: int, N: int, C: int, H: int, shifted_period: int = 0, elt=2) -> Work:
    """``nB`` windows of ``N`` tokens and ``C`` channels (``H`` heads)."""
    flops = 4.0 * nB * N * N * C
    nbytes = 4 * elt * nB * N * C + 4 * H * N * N + 4 * shifted_period * N * N
    return flops, nbytes


def window_bwd(nB: int, N: int, C: int, H: int, shifted_period: int = 0, elt=2) -> Work:
    flops = 10.0 * nB * N * N * C
    nbytes = 7 * elt * nB * N * C + 8 * H * N * N + 4 * shifted_period * N * N
    return flops, nbytes


def decode_attention(B: int, valid_keys: int, H: int, D: int, Lk_pad: int, elt=2) -> Work:
    """One single-token step over ``valid_keys`` valid keys summed over the
    batch: 4 H D a valid key; q and o, the valid keys' K and V, the mask."""
    HD = H * D
    return 4.0 * HD * valid_keys, elt * (2 * B * HD + 2 * valid_keys * HD) + B * Lk_pad


def seconds(calls: Iterable[Work], peak_flops: float, peak_bytes: float) -> float:
    return sum(max(f / peak_flops, b / peak_bytes) for f, b in calls)
