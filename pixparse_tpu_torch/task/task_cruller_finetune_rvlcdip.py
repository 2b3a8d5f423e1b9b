"""RVL-CDIP finetune task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_finetune_rvlcdip`).

Classification as generation: the 16 document classes are ``<letter/>``
style tokens; the sequence ``<s_rvlcdip><class/></s>`` is tokenized to
length 5 (prompt, class, eos and padding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pixparse_tpu_torch.data.preprocess import text_input_to_target
from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    RVLCDIP_FINETUNE_TOKENS,
    RVLCDIP_INT2STR,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    resolve_model_name,
    stack_images,
    tokenize_batch,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg


@dataclass
class TaskCrullerFinetuneRVLCDIPCfg(TaskTrainCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerFinetuneRVLCDIP(BaseCrullerTrainTask):
    task_start_token = "<s_rvlcdip>"
    prompt_end_token = "<s_rvlcdip>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = RVLCDIP_FINETUNE_TOKENS
    text_anno_fn = True
    shift_in_step = False
    collate_text_length = 5  # prompt + class + eos
    int2str = RVLCDIP_INT2STR

    def collate_fn(self, batch):
        images = [self.prepare_image(item["image"]) for item in batch]
        texts = [
            self.task_start_token + "<" + self.int2str[int(item["label"])] + "/>"
            + self.tokenizer.eos_token
            for item in batch
        ]
        text_inputs = tokenize_batch(self.tokenizer, texts, self.collate_text_length)
        targets = np.stack(
            [text_input_to_target(t, self.tokenizer, self.prompt_end_token) for t in text_inputs]
        )
        return {
            "image": stack_images(images),
            "label": text_inputs[:, :-1],
            "text_target": targets[:, 1:],
        }
