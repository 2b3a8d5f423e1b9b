"""Published dense peaks of the cards the benchmark knows, chosen by the
name ``torch.cuda.get_device_name()`` gives (NVIDIA data sheets, without
sparsity): bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor
cores, HBM bytes/s. The rates assume the card's full power limit; a run
records the limit beside its numbers."""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peaks(NamedTuple):
    bf16_flops: float
    fp32_flops: float
    hbm_bytes: float


PEAKS = (  # the first name that matches wins: the more specific ones first
    ("H100 PCIe", Peaks(756e12, 51e12, 2.0e12)),
    ("H100 NVL", Peaks(835e12, 60e12, 3.9e12)),
    ("H200", Peaks(989e12, 67e12, 4.8e12)),
    ("H100", Peaks(989e12, 67e12, 3.35e12)),
)


def peaks_for(card_name: str) -> Optional[Peaks]:
    """The card's peaks, or None for a device without published ones (a
    reader then reports nothing)."""
    for key, peaks in PEAKS:
        if key in card_name:
            return peaks
    return None
