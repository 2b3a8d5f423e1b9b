"""Eval driver (counterpart of :mod:`pixparse_tpu.framework.eval`)."""

from __future__ import annotations

from collections import defaultdict

from pixparse_tpu_torch.framework.task import TaskEval


def evaluate(task: TaskEval, loaders):
    """Run ``task.step`` over every batch of each loader the task keeps
    (``prepare_for_evaluation``) -> ``{loader name: {"average": metrics}}``
    (per-batch metrics by index when the task does not average)."""
    metrics = defaultdict(dict)
    eval_loaders = task.prepare_for_evaluation(loaders)
    for key, loader in eval_loaders.items():
        for batch_idx, sample in enumerate(loader.loader):
            metrics[key][batch_idx] = task.step(sample)
        if hasattr(task, "average_metrics"):
            metrics[key] = {"average": task.average_metrics(metrics[key])}
    return dict(metrics)
