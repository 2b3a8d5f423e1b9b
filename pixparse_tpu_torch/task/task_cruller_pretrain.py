"""Cruller pretrain task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_pretrain`).

Text-reading pretraining on webdataset OCR shards: task token
``<s_pretrain>``, the ``preprocess_ocr_anno`` annotation pipeline (random
page, tokenize to max length, -100 masking), next-token CE over the shifted
sequence. The optimizer and step machinery is in
:class:`~pixparse_tpu_torch.task.cruller_base.BaseCrullerTrainTask`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

from pixparse_tpu_torch.data.preprocess import preprocess_ocr_anno, preprocess_text_anno
from pixparse_tpu_torch.data.wds import default_collate
from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    PRETRAIN_TASK_START,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    resolve_model_name,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg


@dataclass
class TaskCrullerPretrainCfg(TaskTrainCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerPretrain(BaseCrullerTrainTask):
    task_start_token = PRETRAIN_TASK_START
    prompt_end_token = PRETRAIN_TASK_START
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = None
    text_anno_fn = False  # OCR-anno pipeline (multi-page random sampling)
    shift_in_step = True

    def __init__(self, cfg: TaskCrullerPretrainCfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        preproc_fn = preprocess_text_anno if self.text_anno_fn else preprocess_ocr_anno
        self.anno_preprocess_train = partial(
            preproc_fn,
            tokenizer=self.tokenizer,
            max_position_embeddings=self.max_position_embeddings,
            task_start_token=self.task_start_token,
            prompt_end_token=self.prompt_end_token,
        )

    def collate_fn(self, batch):
        # the wds pipeline already produced fixed-shape arrays: plain stacking
        return default_collate(batch)
