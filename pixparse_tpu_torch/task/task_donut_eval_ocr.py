"""Donut baseline OCR eval task (counterpart of
:mod:`pixparse_tpu.task.task_donut_eval_ocr`).

Runs a published HF Donut model (``naver-clova-ix/donut-base-finetuned-
cord-v2`` by default) through the eval harness and the OCR metrics, so
Cruller numbers have an external reference point. The HF model's own
attention is the baseline under test: this task runs no kernel of the
port. Model and processor come from the ``_load_hf`` hook, which imports
``transformers`` only when called and reads local files only (a local
path, or a model already in the HF cache); tests inject a tiny
``VisionEncoderDecoderModel`` built in-process. Unlike the JAX task, the
model and ``pixel_values`` go to the task's device (``--task.device``,
``cuda`` by default).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.framework.task import TaskEval
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from pixparse_tpu_torch.utils.ocr_eval import ocr_metrics_from_text


@dataclass
class TaskDonutEvalOCRCfg(TaskEvalCfg):
    model_name: str = "naver-clova-ix/donut-base-finetuned-cord-v2"
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        # an external HF model: no registry lookup. The eval app's loader
        # reads ``image_fmt`` only, and the Donut processor takes RGB pages
        # (the JAX task leaves the default 'L')
        self.model.image_encoder.image_fmt = "RGB"


class TaskDonutEvalOCR(TaskEval):
    """External-baseline eval: HF Donut greedy generation + CER/WER."""

    def __init__(self, cfg: TaskDonutEvalOCRCfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.device = device_env.device
        self.processor, self.model = self._load_hf(cfg.model_name)
        self.model = self.model.to(self.device).eval()
        self.task_prompt = "<s_cord-v2>"
        # the eval pipe calls anno_preprocess(anno); the baseline needs the
        # raw page text as reference (no tokenization)
        self.anno_preprocess_eval = self._raw_text_anno
        self.image_preprocess_eval = lambda img: img  # the processor handles it

    @staticmethod
    def _load_hf(model_name: str):
        """The HF processor and model from a local path or the HF cache
        (``local_files_only``: never the network). Split out so tests can
        inject a locally built tiny model."""
        try:
            from transformers import DonutProcessor, VisionEncoderDecoderModel
        except ImportError as e:
            raise RuntimeError("donut_eval_ocr needs the transformers package") from e
        return (
            DonutProcessor.from_pretrained(model_name, local_files_only=True),
            VisionEncoderDecoderModel.from_pretrained(model_name, local_files_only=True),
        )

    @staticmethod
    def _raw_text_anno(anno):
        pages = anno.get("pages", []) if isinstance(anno, dict) else []
        text = "\n".join(pages[0].get("text", [])) if pages else str(anno)
        return {"text": [text], "target": [text]}

    def collate_fn(self, batch):
        """The eval pipe's ``(image, text, target)`` tuples -> ``(images,
        texts)``; any other batch (a list of per-sample dicts from an HF
        dataset) passes through. The JAX task passes the tuples through too,
        and its ``step`` then reads the first two samples as images and
        texts."""
        if batch and all(isinstance(s, tuple) for s in batch):
            return [s[0] for s in batch], [str(s[1]) for s in batch]
        return batch

    def setup(self):
        pass

    def prepare_for_evaluation(self, loaders) -> Dict[str, Any]:
        return {name: loader for name, loader in loaders.items() if "eval" in name}

    def step(self, sample) -> Dict[str, Any]:
        if isinstance(sample, (tuple, list)) and len(sample) >= 2 and not isinstance(
            sample[0], dict
        ):
            images, texts = sample[0], sample[1]
        elif isinstance(sample, (tuple, list)):
            # list of per-sample dicts (the HF-dataset path's passthrough)
            images = [s["image"] for s in sample]
            texts = [s.get("text", "") for s in sample]
        else:
            images, texts = sample["image"], sample["text"]
        tokenizer = self.processor.tokenizer
        predictions, references = [], []
        for img, ref in zip(images, texts):
            pixel_values = self.processor(img, return_tensors="pt").pixel_values
            decoder_input_ids = tokenizer(
                self.task_prompt, add_special_tokens=False, return_tensors="pt"
            ).input_ids
            unk = tokenizer.unk_token_id
            with torch.inference_mode():
                outputs = self.model.generate(
                    pixel_values.to(self.device, self.model.dtype),
                    decoder_input_ids=decoder_input_ids.to(self.device),
                    max_length=self.model.decoder.config.max_position_embeddings,
                    pad_token_id=tokenizer.pad_token_id,
                    eos_token_id=tokenizer.eos_token_id,
                    use_cache=True,
                    # tokenizers without an unk token (byte-level) skip it
                    bad_words_ids=[[unk]] if unk is not None else None,
                )
            seq = self.processor.batch_decode(outputs.cpu())[0]
            seq = seq.replace(tokenizer.eos_token, "").replace(tokenizer.pad_token, "")
            seq = re.sub(r"<.*?>", "", seq, count=1).strip()  # the first tag: the prompt
            predictions.append(seq)
            references.append(ref if isinstance(ref, str) else str(ref))
        metrics, _ = ocr_metrics_from_text(predictions, references)
        return metrics or {}

    def average_metrics(self, metrics: Dict[int, Dict[str, float]]):
        wer = [m["wer"] for m in metrics.values() if "wer" in m]
        cer = [m["cer"] for m in metrics.values() if "cer" in m]
        if not wer:
            return {}
        return {"wer": float(np.mean(wer)), "cer": float(np.mean(cer))}

    def end(self):
        pass
