"""Device resolution (counterpart of the single-device part of
:mod:`pixparse_tpu.parallel.mesh`).

A process runs on one CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). There is no silent fallback: asking
for CUDA on a machine without it raises. Several processes, one device
each, form a mesh in :mod:`pixparse_tpu_torch.parallel.mesh`, which
resolves each rank's device here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def batch_to_device(batch, device: torch.device):
    """A nested dict of numpy arrays or tensors -> the same dict of tensors
    on ``device`` (dtypes kept; host copies are asynchronous). Host arrays'
    bytes count as ``h2d_bytes`` (:func:`~pixparse_tpu_torch.framework.profiling.count`)."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if batch.device.type == "cpu":
        # imported here: the framework package imports this module
        from pixparse_tpu_torch.framework.profiling import count

        count("h2d_bytes", batch.nbytes)
    return batch.to(device, non_blocking=True)


@dataclass
class DeviceEnv:
    """One process on one device, alone: no mesh, nothing sharded
    (:class:`pixparse_tpu_torch.parallel.mesh.MeshEnv` is the entry points'
    environment, and the same as this one without a distributed
    environment)."""

    device: torch.device
    world_size: int = 1
    global_rank: int = 0
    mesh = None  # class attribute: a process alone has no mesh

    @property
    def data_size(self) -> int:
        """Processes that read different data (as ``MeshEnv.data_size``)."""
        return self.world_size

    def shard_batch(self, batch, stacked: bool = False):
        """The batch on the device (one process holds the whole batch)."""
        return batch_to_device(batch, self.device)

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
