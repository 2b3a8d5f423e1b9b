"""DocVQA eval task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_eval_docvqa`).

Prompt ``<s_docvqa><s_question>{q}</s_question><s_answer>`` -> greedy
decode, the ``answer`` field parsed from the generated JSON, ANLS over all
predictions. Questions differ in length: the prompts are right-padded to the
batch's longest and :func:`~pixparse_tpu_torch.ops.generation.generate`
left-aligns them, masking the pad keys, so one batched decode serves them
all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    DOCVQA_FINETUNE_TOKENS,
    SPECIAL_TOKENS_FROM_PRETRAIN,
    batch_images,
    resolve_model_name,
    stack_images,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils.json_utils import token2json
from pixparse_tpu_torch.utils.metrics import average_normalized_levenshtein_similarity


@dataclass
class TaskCrullerEvalDOCVQACfg(TaskEvalCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskCrullerEvalDOCVQA(BaseCrullerEvalTask):
    task_start_token = "<s_docvqa>"
    prompt_end_token = "<s_answer>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = DOCVQA_FINETUNE_TOKENS
    max_generation_length = 512

    def __init__(self, cfg: TaskCrullerEvalDOCVQACfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.all_ground_truths = []
        self.all_predictions = []

    def collate_fn(self, batch):
        images, questions, answers, question_ids = [], [], [], []
        for item in batch:
            images.append(self.prepare_image(item["image"]))
            labels = item["labels"]
            questions.append(labels["question"])
            answers.append(labels["answers"])
            question_ids.append(item.get("question_id"))
        return {
            "images": stack_images(images),
            "questions": questions,
            "ground_truth_answers": answers,
            "question_ids": question_ids,
        }

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        return {name: loader for name, loader in loaders.items() if "eval" in name}

    def batch_prompts(self, questions) -> np.ndarray:
        """Each question's prompt ids, right-padded to the batch's longest."""
        rows = [
            self.tokenizer.encode(
                self.task_start_token + "<s_question>" + q + "</s_question>" + "<s_answer>",
                add_special_tokens=False,
            )
            for q in questions
        ]
        out = np.full((len(rows), max(len(r) for r in rows)), self.tokenizer.pad_token_id, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def step(self, batch) -> Dict[str, Any]:
        images = batch_images(batch["images"])
        prompts = self.batch_prompts(batch["questions"])
        generated = self.generate_text(images, prompts, self.max_generation_length)
        for text, answers in zip(generated, batch["ground_truth_answers"]):
            self.all_ground_truths.append(answers)
            self.all_predictions.append(token2json(text).get("answer", ""))
        return {}

    def average_metrics(self, metrics: Dict[int, Dict[str, Any]]):
        anls = average_normalized_levenshtein_similarity(
            ground_truth=self.all_ground_truths, predicted_answers=self.all_predictions,
        )
        self.all_ground_truths = []
        self.all_predictions = []
        return {"ANLS": anls}
