"""RVL-CDIP eval task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_eval_rvlcdip`).

Classification by generation: a batched greedy decode of at most 6 tokens
from ``<s_rvlcdip>``; the generated ``<class/>`` tag must equal the ground
truth's exactly; accuracy over the readable samples.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    RVLCDIP_FINETUNE_TOKENS,
    RVLCDIP_INT2STR,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    batch_images,
    resolve_model_name,
    stack_images,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg

_logger = logging.getLogger(__name__)


@dataclass
class TaskCrullerEvalRVLCDIPCfg(TaskEvalCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerEvalRVLCDIP(BaseCrullerEvalTask):
    task_start_token = "<s_rvlcdip>"
    prompt_end_token = "<s_rvlcdip>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = RVLCDIP_FINETUNE_TOKENS
    max_generation_length = 6  # prompt + class token + eos, and one more step
    int2str = RVLCDIP_INT2STR

    def collate_fn(self, batch):
        """Unreadable images are dropped; a batch with none left is None."""
        images, labels = [], []
        for item in batch:
            try:
                images.append(self.prepare_image(item["image"]))
                labels.append(int(item["label"]))
            except Exception as e:  # an undecodable image file
                _logger.warning("skipping unreadable eval image: %s", e)
        if not images:
            return None
        return {"image": stack_images(images), "label": np.asarray(labels)}

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        return {name: loader for name, loader in loaders.items() if "eval" in name}

    def step(self, sample) -> Dict[str, Any]:
        if sample is None:
            return {"classification": {"correct_samples": 0, "n_valid_samples": 0}}
        images = batch_images(sample["image"])
        labels = [self.int2str[int(x)] for x in sample["label"]]
        prompt = self.prompt_ids(self.task_start_token, images.shape[0])
        generated = self.generate_text(images, prompt, self.max_generation_length)
        correct = 0
        for text, gt in zip(generated, labels):
            predicted = (
                text.replace("<s_rvlcdip>", "").replace("</s>", "").replace("<s>", "")
                .replace("<pad>", "").strip()
            )
            correct += predicted == f"<{gt}/>"
        return {"classification": {"correct_samples": correct, "n_valid_samples": len(labels)}}

    def average_metrics(self, metrics: Dict[int, Dict[str, Any]]):
        correct = sum(m["classification"]["correct_samples"] for m in metrics.values())
        total = sum(m["classification"]["n_valid_samples"] for m in metrics.values())
        return {"classification": {"accuracy": correct / max(1, total)}}
