"""Task base classes (counterpart of :mod:`pixparse_tpu.framework.task`).

The lifecycle surface the apps drive: ``train_setup`` /
``train_interval_start`` / ``train_step`` / ``train_interval_end`` /
``state_dict`` for training, ``setup`` / ``prepare_for_evaluation`` /
``step`` / ``end`` for eval. A task runs in a
:class:`~pixparse_tpu_torch.parallel.mesh.MeshEnv` (the entry points') or a
:class:`~pixparse_tpu_torch.device.DeviceEnv` (one process alone)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.parallel.mesh import MeshEnv

Env = Union[MeshEnv, DeviceEnv]


class StopTraining(Exception):
    """Raised from a train step when a graceful stop was requested."""


class Task:
    def __init__(self, cfg, device_env: Env, monitor=None):
        self.cfg = cfg
        self.device_env = device_env
        self.monitor = monitor


class TaskEval(Task):
    def collate_fn(self, batch):
        pass

    def setup(self, *args, **kwargs):
        pass

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        pass

    def step(self, sample) -> Dict[str, Any]:
        pass

    def end(self):
        pass


class TaskTrain(Task):
    def __init__(self, cfg, device_env: Env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.num_intervals = cfg.num_intervals
        self.num_warmup_intervals = cfg.num_warmup_intervals
        self.eval_frequency = cfg.eval_frequency
        self.num_steps_per_interval: Optional[int] = None

        self.step_idx = 0  # train steps taken (micro-batches when accumulating)
        self.batch_idx = 0  # global batches seen
        self.interval_idx = 0
        self.interval_batch_idx = 0
        self.start_interval = 0  # set by resume (app layer)
        self._stop_requested = False  # set by the app's signal handler

        # optimization slots, filled by train_setup
        self.optimizer = None  # framework.optimization.Optimizer
        self.scheduler = None  # update count -> learning rate
        self.state = None  # framework.train_state.TrainState
        self.train_step_fn = None

    def collate_fn(self, batch):
        pass

    def train_setup(self, num_batches_per_interval: int, *args, **kwargs):
        pass

    def train_interval_start(self):
        pass

    def train_interval_end(self):
        pass

    def train_step(self, sample) -> Dict[str, Any]:
        pass

    def get_current_lr(self) -> float:
        if self.scheduler is None:
            return 0.0
        accum = max(1, getattr(self.cfg.opt, "grad_accum_steps", 1))
        return float(self.scheduler(self.step_idx // accum))

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state_dict: Dict[str, Any]):
        pass
