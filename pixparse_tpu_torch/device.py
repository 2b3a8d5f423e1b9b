"""Device resolution (counterpart of the single-device part of
:mod:`pixparse_tpu.parallel.mesh`).

The port runs on one CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). There is no silent fallback: asking
for CUDA on a machine without it raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``'cuda'``, ``'cuda:N'`` or ``'cpu'`` -> :class:`torch.device`.
    Raises ``RuntimeError`` when CUDA is asked for and not available."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was requested but CUDA is not available; pass "
            "device='cpu' (--task.device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda, cuda:N or cpu)")
    return device


@dataclass
class DeviceEnv:
    """One process on one device (multi-GPU arrives with torch.distributed)."""

    device: torch.device
    world_size: int = 1
    global_rank: int = 0

    @classmethod
    def initialize(cls, device: str = "cuda") -> "DeviceEnv":
        return cls(device=resolve_device(device))

    def is_primary(self) -> bool:
        return self.global_rank == 0

    def __str__(self):
        name = self.device.type
        if self.device.type == "cuda":
            name = torch.cuda.get_device_name(self.device)
        return f"DeviceEnv(device={self.device}, {name})"
