"""The one generator of inputs, driven by a cell's ``params``: page images,
pretraining token rows and DocVQA-style questions, all from a numpy
generator seeded from the run's seed. The same seed gives the same inputs;
every seed gives the same sizes drawn from the same ranges."""

from __future__ import annotations

import string
from typing import Dict, List, Tuple

import numpy as np

from bench_lib.seeds import mix

TRAFFIC_SALT = 0x7AFF_1C00


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(mix(seed, TRAFFIC_SALT + stream))


def pages(rng: np.random.Generator, B: int, H: int, W: int, C: int) -> np.ndarray:
    """``(B, H, W, C)`` float32 page images already normalized to [-1, 1]:
    a white page with dark, noisy text lines of random lengths."""
    pitch = max(6, H // 64)  # line pitch in pixels
    height = max(3, (pitch * 3) // 5)  # ink height of a line
    rows = np.arange(H)
    line = rows // pitch
    inked_row = (rows % pitch) < height
    n_lines = H // pitch + 1
    out = np.empty((B, H, W, C), np.float32)
    cols = np.arange(W)[None, :]
    for b in range(B):
        ends = rng.integers(W // 8, W, size=n_lines)
        starts = rng.integers(0, W // 10, size=n_lines)
        mask = inked_row[:, None] & (cols >= starts[line][:, None]) & (cols < ends[line][:, None])
        ink = rng.random((H, W), dtype=np.float32) * 1.2 - 1.0  # [-1, 0.2)
        out[b] = np.where(mask, ink, 1.0)[:, :, None]
    return out


def pretrain_rows(rng: np.random.Generator, B: int, positions: int, real: Tuple[int, int],
                  vocab: int, first_id: int, start_id: int, eos_id: int,
                  pad_id: int, ignore_id: int = -100) -> Tuple[np.ndarray, np.ndarray]:
    """Unshifted ``(text, target)`` rows of ``positions`` columns, as the
    pretrain collate makes them: the task token, then ``n`` tokens ending
    with EOS, ``n`` uniform in ``real`` (inclusive), then pad; the target is
    the text with pad and the task token ignored. After the task's shift a
    row has exactly ``n`` valid targets."""
    lo, hi = real
    if not (1 <= lo <= hi <= positions - 1):
        raise ValueError(f"real lengths {real} do not fit {positions} positions")
    n = rng.integers(lo, hi + 1, size=B)
    body = rng.integers(first_id, vocab, size=(B, positions), dtype=np.int64)
    col = np.arange(positions)[None, :]
    text = np.where((col >= 1) & (col <= n[:, None]), body, pad_id)
    text[:, 0] = start_id
    text[np.arange(B), n] = eos_id
    target = np.where((col >= 1) & (col <= n[:, None]), text, ignore_id)
    return text.astype(np.int64), target.astype(np.int64)


def questions(rng: np.random.Generator, B: int, chars: Tuple[int, int]) -> List[str]:
    """``B`` question strings of lowercase letters and spaces, lengths
    uniform in ``chars`` (inclusive); the byte-level tokenizer makes one
    token of each character."""
    alphabet = np.array(list(string.ascii_lowercase + " "))
    lens = rng.integers(chars[0], chars[1] + 1, size=B)
    return ["".join(rng.choice(alphabet, size=n)) for n in lens]


def image_shape(cfg: Dict) -> Tuple[int, int, int]:
    enc = cfg["encoder"]
    return enc["image_size"][0], enc["image_size"][1], enc["in_chans"]
