"""Interval loop (counterpart of :mod:`pixparse_tpu.framework.train`)."""

from __future__ import annotations

from pixparse_tpu_torch.framework.task import TaskTrain


def train_one_interval(task: TaskTrain, loader):
    task.train_interval_start()
    for sample in loader.loader:
        task.train_step(sample)
    task.train_interval_end()
