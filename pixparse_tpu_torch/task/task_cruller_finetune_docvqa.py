"""DocVQA finetune task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_finetune_docvqa`).

Q&A finetuning: one random Q&A pair per image per epoch, the sequence
``<s_docvqa><s_question>q</s_question><s_answer>a</s_answer></s>`` tokenized
to 512 (clamped to the position table). ``prompt_end_token`` is
``<s_answer>``, so the loss covers the answer span only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pixparse_tpu_torch.data.preprocess import text_input_to_target
from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    DOCVQA_FINETUNE_TOKENS,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    resolve_model_name,
    stack_images,
    tokenize_batch,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg


@dataclass
class TaskCrullerFinetuneDOCVQACfg(TaskTrainCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerFinetuneDOCVQA(BaseCrullerTrainTask):
    task_start_token = "<s_docvqa>"
    prompt_end_token = "<s_answer>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = DOCVQA_FINETUNE_TOKENS
    text_anno_fn = True
    shift_in_step = False
    collate_text_length = 512

    def collate_fn(self, batch):
        images = [self.prepare_image(item["image"]) for item in batch]
        # the global numpy stream, as the JAX task draws it (seeded by
        # random_seed(seed, rank) at the app's start)
        q_and_as = [np.random.choice(item["labels"]) for item in batch]
        texts = [self.task_start_token + str(text) + self.tokenizer.eos_token for text in q_and_as]
        text_inputs = tokenize_batch(self.tokenizer, texts, self.collate_text_length)
        targets = np.stack(
            [text_input_to_target(t, self.tokenizer, self.prompt_end_token) for t in text_inputs]
        )
        return {
            "image": stack_images(images),
            "label": text_inputs[:, :-1],
            "text_target": targets[:, 1:],
        }
