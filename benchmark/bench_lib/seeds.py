"""Seeds derived from the run's ``--seed`` (any whole number, larger than
32 bits holds): a fixed splitmix-style mix of the seed and a salt per use,
below 2**63 so that every generator takes it."""

from __future__ import annotations

M64 = (1 << 64) - 1


def mix(seed: int, salt: int) -> int:
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(salt) * 0xBF58476D1CE4E5B9) & M64
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & M64
    x ^= x >> 32
    return x & ((1 << 63) - 1)
