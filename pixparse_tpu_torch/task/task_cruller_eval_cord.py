"""CORD eval task (counterpart of :mod:`pixparse_tpu.task.task_cruller_eval_cord`).

JSON-completion eval on cord-v2 test: a batched greedy decode from
``<s_cord>``, ``token2json`` on both sides, per-sample nTED accuracy and a
run-level field micro-F1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    CORD_FINETUNE_TOKENS,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    batch_images,
    resolve_model_name,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.task.task_cruller_finetune_cord import cord_collate
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils.json_utils import JSONParseEvaluator, token2json


@dataclass
class TaskCrullerEvalCORDCfg(TaskEvalCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerEvalCORD(BaseCrullerEvalTask):
    task_start_token = "<s_cord>"
    prompt_end_token = "<s_cord>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = CORD_FINETUNE_TOKENS
    max_generation_length = 512

    def __init__(self, cfg: TaskCrullerEvalCORDCfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.evaluator = JSONParseEvaluator()
        self.all_ground_truths = []
        self.all_predictions = []
        self.acc_list = []

    def collate_fn(self, batch):
        return cord_collate(self, batch)

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        return {name: loader for name, loader in loaders.items() if "eval" in name}

    def step(self, batch) -> Dict[str, Any]:
        images = batch_images(batch["image"])
        labels = np.asarray(batch["label"])
        prompt = self.prompt_ids(self.task_start_token, images.shape[0])
        generated = self.generate_text(images, prompt, self.max_generation_length)
        acc = 0.0
        for row_label, text in zip(labels, generated):
            decoded_gt = self.tokenizer.decode(
                row_label[row_label != self.tokenizer.pad_token_id].astype(np.int64).tolist()
            )
            ground_truth = token2json(decoded_gt)
            predicted_json = token2json(text)
            self.all_predictions.append(predicted_json)
            self.all_ground_truths.append(ground_truth)
            acc = self.evaluator.cal_acc(predicted_json, ground_truth)
            self.acc_list.append(acc)
        # as the JAX task (and the reference) report it: the batch's LAST
        # sample's accuracy; the run-level averages are the real metric
        return {"batch_accuracy": acc}

    def average_metrics(self, metrics: Dict[int, Dict[str, float]]):
        avg_accuracy = float(np.mean(self.acc_list)) if self.acc_list else 0.0
        f1 = self.evaluator.cal_f1(self.all_predictions, self.all_ground_truths)
        self.all_ground_truths = []
        self.all_predictions = []
        self.acc_list = []
        return {"average_accuracy": avg_accuracy, "f1_score": f1}
