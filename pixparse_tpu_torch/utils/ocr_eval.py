"""OCR eval metric assembly (the port's own copy of
:mod:`pixparse_tpu.utils.ocr_eval`): -100 -> pad restore, tag and newline
stripping, empty-pair filtering, prediction truncated to the reference's
length, then CER/WER. The generation itself is the KV-cached greedy decode in
:mod:`pixparse_tpu_torch.ops.generation`.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pixparse_tpu_torch.utils.text_metrics import get_cer_wer_metrics

IGNORE_ID = -100


def clean_ocr_text(text: str) -> str:
    """Strip markup tags and newlines."""
    return re.sub(r"<.*?>", "", re.sub("\n", " ", text))


def restore_ignored(ids: np.ndarray, pad_token_id: int) -> np.ndarray:
    out = np.asarray(ids).copy()
    out[out == IGNORE_ID] = pad_token_id
    return out


def max_target_length(
    ids: np.ndarray, pad_token_id: int, cap: int, bucket: int = 64
) -> int:
    """Per-batch decode-length cap, rounded UP
    to a ``bucket`` multiple (the decode loop exits early, so the headroom is
    free)."""
    lengths = (np.asarray(ids) != pad_token_id).sum(axis=1)
    n = int(min(cap, lengths.max())) if lengths.size else cap
    return int(min(cap, ((n + bucket - 1) // bucket) * bucket))


def ocr_metrics_from_text(
    predictions: Sequence[str],
    references: Sequence[str],
) -> Tuple[Optional[Dict[str, float]], Optional[Dict[str, str]]]:
    """Cleaned text pairs -> ({wer, cer}, first reconstruction sample); None
    when every pair is empty after cleaning."""
    preds = [clean_ocr_text(t) for t in predictions]
    refs = [clean_ocr_text(t) for t in references]
    filtered = [(r, p) for r, p in zip(refs, preds) if r and p]
    if not filtered:
        return None, None
    refs, preds = map(list, zip(*filtered))
    preds = [p[: len(r)] for p, r in zip(preds, refs)]
    metrics: Dict[str, float] = {}
    metrics = get_cer_wer_metrics(metrics, preds, refs)
    reconstruction = {"original_text": refs[0], "reconstructed_text": preds[0]}
    return metrics, reconstruction
