"""Task registry (counterpart of :mod:`pixparse_tpu.task.task_factory`):
public task names -> ``(TaskClass, TaskCfg)``. The other tasks join as
their slices are ported (ROADMAP.md Queue 1)."""

from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg

TASK_CLASS_REGISTRY = {
    "cruller_eval_ocr": (TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg),
}
