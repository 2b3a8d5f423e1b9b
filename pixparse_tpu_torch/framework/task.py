"""Task base classes (counterpart of :mod:`pixparse_tpu.framework.task`;
``TaskTrain`` arrives with the training slice, ``collate_fn``/``step``
with the eval CLI)."""

from __future__ import annotations

from pixparse_tpu_torch.device import DeviceEnv


class Task:
    def __init__(self, cfg, device_env: DeviceEnv, monitor=None):
        self.cfg = cfg
        self.device_env = device_env
        self.monitor = monitor


class TaskEval(Task):
    def setup(self, *args, **kwargs):
        pass

    def end(self):
        pass
