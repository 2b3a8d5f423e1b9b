"""OCR eval task (counterpart of :mod:`pixparse_tpu.task.task_cruller_eval_ocr`).

Batched greedy OCR reconstruction on FUNSD-style shards -> CER/WER per batch,
averaged. Generation is the KV-cached greedy decode of
:class:`~pixparse_tpu_torch.task.cruller_base.BaseCrullerEvalTask`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, Optional

import numpy as np

from pixparse_tpu_torch.data.preprocess import preprocess_ocr_anno
from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.task.common import (
    PRETRAIN_TASK_START,
    SEP_TOKEN,
    batch_images,
    resolve_model_name,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils.ocr_eval import (
    max_target_length,
    ocr_metrics_from_text,
    restore_ignored,
)

_logger = logging.getLogger(__name__)


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

    def __init__(self, cfg: TaskCrullerEvalOCRCfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.anno_preprocess_eval = partial(
            preprocess_ocr_anno,
            tokenizer=self.tokenizer,
            max_position_embeddings=self.max_position_embeddings,
            task_start_token=self.task_start_token,
            prompt_end_token=self.prompt_end_token,
        )

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        """Keep the eval-named loaders."""
        return {name: loader for name, loader in loaders.items() if name in ("eval", "eval_FUNSD")}

    def step(self, sample) -> Dict[str, Any]:
        """One batch: greedy decode + CER/WER ({} when every pair cleans to
        empty text)."""
        t0 = time.perf_counter()
        if isinstance(sample, (tuple, list)):
            image, text, _target = sample[:3]
            sample = {"image": image, "text": text}
        images = batch_images(sample["image"])
        text = np.asarray(sample["text"])
        if text.ndim == 3:
            text = text[:, 0]
        text = restore_ignored(text, self.tokenizer.pad_token_id)
        max_len = max_target_length(text, self.tokenizer.pad_token_id, self.max_generation_length)
        prompt = self.prompt_ids(self.task_start_token, images.shape[0])
        generated = self.generate_text(images, prompt, max_length=max_len)
        references = self.tokenizer.batch_decode(text.astype(np.int64).tolist())
        metrics, _recon = ocr_metrics_from_text(generated, references)
        _logger.info("eval ocr step took %.2fs", time.perf_counter() - t0)
        return metrics or {}

    def average_metrics(self, metrics: Dict[int, Dict[str, float]]) -> Dict[str, float]:
        wer = [m["wer"] for m in metrics.values() if "wer" in m]
        cer = [m["cer"] for m in metrics.values() if "cer" in m]
        if not wer:
            return {}
        return {"wer": float(np.mean(wer)), "cer": float(np.mean(cer))}
