"""OCR eval task (counterpart of :mod:`pixparse_tpu.task.task_cruller_eval_ocr`).
The class carries the task's tokens and generation cap; ``step`` and the
CER/WER metrics arrive with the eval-CLI slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import PRETRAIN_TASK_START, SEP_TOKEN, resolve_model_name
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg


@dataclass
class TaskCrullerEvalOCRCfg(TaskEvalCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerEvalOCR(BaseCrullerEvalTask):
    task_start_token = PRETRAIN_TASK_START
    prompt_end_token = PRETRAIN_TASK_START
    base_special_tokens = [SEP_TOKEN, PRETRAIN_TASK_START]
    finetune_special_tokens = None
    max_generation_length = 1000  # reference ``get_generated_tokens`` cap
