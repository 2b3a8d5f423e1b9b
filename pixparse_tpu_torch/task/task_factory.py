"""Task registry and factory (counterpart of
:mod:`pixparse_tpu.task.task_factory`): public task names ->
``(TaskClass, TaskCfg)``; ``create_task`` builds the cfg from parsed args and
the task from ``(cfg, device_env, monitor)``. Ten of the JAX package's
eleven tasks; ``pix2struct_pretrain`` is not ported yet (ROADMAP.md Queue
1)."""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from pixparse_tpu_torch.task.task_cruller_eval_cord import (
    TaskCrullerEvalCORD,
    TaskCrullerEvalCORDCfg,
)
from pixparse_tpu_torch.task.task_cruller_eval_docvqa import (
    TaskCrullerEvalDOCVQA,
    TaskCrullerEvalDOCVQACfg,
)
from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg
from pixparse_tpu_torch.task.task_cruller_eval_rvlcdip import (
    TaskCrullerEvalRVLCDIP,
    TaskCrullerEvalRVLCDIPCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_cord import (
    TaskCrullerFinetuneCORD,
    TaskCrullerFinetuneCORDCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_docvqa import (
    TaskCrullerFinetuneDOCVQA,
    TaskCrullerFinetuneDOCVQACfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_rvlcdip import (
    TaskCrullerFinetuneRVLCDIP,
    TaskCrullerFinetuneRVLCDIPCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_xent import (
    TaskCrullerFinetuneXent,
    TaskCrullerFinetuneXentCfg,
)
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.task.task_donut_eval_ocr import TaskDonutEvalOCR, TaskDonutEvalOCRCfg

TASK_CLASS_REGISTRY = {
    "cruller_eval_ocr": (TaskCrullerEvalOCR, TaskCrullerEvalOCRCfg),
    "cruller_eval_rvlcdip": (TaskCrullerEvalRVLCDIP, TaskCrullerEvalRVLCDIPCfg),
    "cruller_eval_cord": (TaskCrullerEvalCORD, TaskCrullerEvalCORDCfg),
    "cruller_eval_docvqa": (TaskCrullerEvalDOCVQA, TaskCrullerEvalDOCVQACfg),
    "cruller_pretrain": (TaskCrullerPretrain, TaskCrullerPretrainCfg),
    "cruller_finetune_rvlcdip": (TaskCrullerFinetuneRVLCDIP, TaskCrullerFinetuneRVLCDIPCfg),
    "cruller_finetune_cord": (TaskCrullerFinetuneCORD, TaskCrullerFinetuneCORDCfg),
    "cruller_finetune_docvqa": (TaskCrullerFinetuneDOCVQA, TaskCrullerFinetuneDOCVQACfg),
    "cruller_finetune_xent": (TaskCrullerFinetuneXent, TaskCrullerFinetuneXentCfg),
    "donut_eval_ocr": (TaskDonutEvalOCR, TaskDonutEvalOCRCfg),
}


class TaskFactory:
    @staticmethod
    def task_names():
        return list(TASK_CLASS_REGISTRY.keys())

    @staticmethod
    def create_task(task_name: str, task_args: Any, device_env, monitor=None) -> Tuple[Any, Any]:
        name = task_name.lower()
        if name not in TASK_CLASS_REGISTRY:
            raise ValueError(f"unknown task {task_name!r} (known: {sorted(TASK_CLASS_REGISTRY)})")
        task_cls, task_cfg_cls = TASK_CLASS_REGISTRY[name]
        if isinstance(task_args, task_cfg_cls):
            task_cfg = task_args
        elif dataclasses.is_dataclass(task_args):
            # re-scope a generic TaskTrainCfg/TaskEvalCfg parse into the
            # task-specific cfg class (shared fields carried over)
            names = {g.name for g in dataclasses.fields(task_cfg_cls)}
            shared = {
                f.name: getattr(task_args, f.name)
                for f in dataclasses.fields(task_args) if f.name in names
            }
            task_cfg = task_cfg_cls(**shared)
        elif isinstance(task_args, dict):
            task_cfg = task_cfg_cls(**task_args)
        else:
            raise TypeError(f"cannot build {task_cfg_cls} from {type(task_args)}")
        return task_cls(task_cfg, device_env, monitor), task_cfg
