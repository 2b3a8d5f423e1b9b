"""CORD finetune task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_finetune_cord`).

JSON-completion finetuning on naver-clova-ix/cord-v2: ``gt_parse`` dicts are
serialized to ``<s_key>...</s_key>`` token streams (``json2token``),
tokenized to 512 (clamped to the position table), prompt and pad positions
masked to -100, sequences shifted in the collate. Vocabulary: the pretrain
tokens first, then the CORD field tokens, replayed by the base class so a
pretrain checkpoint imports with its table grown.
"""

from __future__ import annotations

from ast import literal_eval
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pixparse_tpu_torch.data.preprocess import text_input_to_target
from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    CORD_FINETUNE_TOKENS,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    resolve_model_name,
    stack_images,
    tokenize_batch,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils.json_utils import json2token


@dataclass
class TaskCrullerFinetuneCORDCfg(TaskTrainCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


def cord_collate(task, batch):
    """CORD items (``image``, ``ground_truth``: a dict or its ``repr``
    holding ``gt_parse``) -> ``{image, label, text_target}``, the sequences
    shifted (label drops the last token, target the first). Shared by the
    CORD finetune and eval tasks."""
    images, texts = [], []
    for item in batch:
        gt = item["ground_truth"]
        if isinstance(gt, str):
            gt = literal_eval(gt)
        tokens_from_json, _ = json2token(
            gt["gt_parse"], task.tokenizer.all_special_tokens, sort_json_key=False
        )
        texts.append(task.task_start_token + tokens_from_json + task.tokenizer.eos_token)
        images.append(task.prepare_image(item["image"]))
    text_inputs = tokenize_batch(task.tokenizer, texts, task.collate_text_length)
    targets = np.stack(
        [text_input_to_target(t, task.tokenizer, task.prompt_end_token) for t in text_inputs]
    )
    return {
        "image": stack_images(images),
        "label": text_inputs[:, :-1],
        "text_target": targets[:, 1:],
    }


class TaskCrullerFinetuneCORD(BaseCrullerTrainTask):
    task_start_token = "<s_cord>"
    prompt_end_token = "<s_cord>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = CORD_FINETUNE_TOKENS
    text_anno_fn = True
    shift_in_step = False  # the collate shifts
    collate_text_length = 512

    def collate_fn(self, batch):
        return cord_collate(self, batch)
