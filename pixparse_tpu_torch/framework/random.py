"""Seeding (counterpart of :mod:`pixparse_tpu.framework.random`): python,
numpy and torch are seeded with ``seed + rank``."""

from __future__ import annotations

import random as _random

import numpy as np
import torch


def random_seed(seed: int = 42, rank: int = 0) -> int:
    effective = seed + rank
    np.random.seed(effective)
    _random.seed(effective)
    torch.manual_seed(effective)
    return effective
