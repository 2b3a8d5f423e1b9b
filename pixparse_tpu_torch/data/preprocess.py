"""Annotation preprocessing: text/OCR annotations -> fixed-shape token arrays
(the port's own copy of :mod:`pixparse_tpu.data.preprocess`; numpy only).

Tokenize to ``max_length`` with pad and truncate, clone to the target, mask
pad and the prompt prefix with -100, sample one random non-empty page.

Prompt masking: the cut position is the *sum of the indices* where the
prompt-end token occurs, plus one. With the single occurrence every task
produces that is ``index + 1`` (mask through the prompt-end token);
degenerate annotations with several occurrences behave as in the JAX
package.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

_logger = logging.getLogger(__name__)

IGNORE_ID = -100


def _tokenize_fixed(tokenizer, text: str, max_length: int) -> np.ndarray:
    out = tokenizer(
        text,
        add_special_tokens=False,
        return_tensors="np",
        max_length=max_length,
        padding="max_length",
        truncation=True,
    )
    return out.input_ids[0].astype(np.int64)


def _mask_target(
    text_ids: np.ndarray,
    pad_token_id: int,
    prompt_end_token_id: int,
    ignore_id: int = IGNORE_ID,
) -> np.ndarray:
    target = text_ids.copy()
    target[target == pad_token_id] = ignore_id
    cut = int((np.nonzero(text_ids == prompt_end_token_id)[0]).sum()) + 1
    target[:cut] = ignore_id
    return target


def preprocess_text_anno(
    anno: str,
    tokenizer: Callable,
    max_position_embeddings: int,
    task_start_token: str,
    prompt_end_token: str,
    ignore_id: int = IGNORE_ID,
    generator: Optional[np.random.RandomState] = None,
):
    """Raw-text annotation -> dict(text=[ids], target=[ids])."""
    text = task_start_token + anno + tokenizer.eos_token
    ids = _tokenize_fixed(tokenizer, text, max_position_embeddings)
    prompt_end_id = tokenizer.convert_tokens_to_ids(prompt_end_token)
    target = _mask_target(ids, tokenizer.pad_token_id, prompt_end_id, ignore_id)
    return dict(text=[ids], target=[target])


def preprocess_ocr_anno(
    anno,
    tokenizer: Callable,
    max_position_embeddings: int,
    task_start_token: str,
    prompt_end_token: str,
    ignore_id: int = IGNORE_ID,
    generator: Optional[np.random.RandomState] = None,
):
    """Multi-page OCR annotation -> one randomly-sampled non-empty page,
    tokenized + masked; returns (dict(text, target), dict(page info))."""
    if isinstance(anno, list):
        _logger.warning("Old [id, {}] annotation form found, correcting...")
        anno = anno[1]

    num_pages = len(anno["pages"])
    if not num_pages:
        raise RuntimeError("Empty annotation. Skipping...")

    if generator is None:
        generator = np.random
    current_index = int(generator.randint(0, num_pages))  # [0, num_pages)
    if not anno["pages"][current_index]["text"]:
        current_index = get_next_valid_page_index(current_index, num_pages, anno)

    prompt_end_id = tokenizer.convert_tokens_to_ids(prompt_end_token)
    page_indices, text_pages, target_pages = [], [], []
    orig_text = ""
    n_wanted_pages = min(1, num_pages)
    while len(text_pages) < n_wanted_pages:
        page = anno["pages"][current_index]
        if not page["text"]:
            raise RuntimeError("No text on page, skipping...")
        orig_text = "\n".join(page["text"])
        text = task_start_token + orig_text + tokenizer.eos_token
        ids = _tokenize_fixed(tokenizer, text, max_position_embeddings)
        target = _mask_target(ids, tokenizer.pad_token_id, prompt_end_id, ignore_id)

        text_pages.append(ids)
        target_pages.append(target)
        page_indices.append(current_index)
        current_index = get_next_valid_page_index(current_index, num_pages, anno)

    return (
        dict(text=text_pages, target=target_pages),
        dict(page_indices=page_indices, num_pages=num_pages, orig_text=orig_text),
    )


def get_next_valid_page_index(
    current_index: int, num_pages: int, anno: dict, retries: int = 10
) -> int:
    """Next page index containing text, wrapping around; RuntimeError after
    ``retries`` attempts."""
    for _ in range(retries):
        current_index = (current_index + 1) % num_pages
        if anno["pages"][current_index]["text"]:
            return current_index
    raise RuntimeError(f"No non-empty page found after {retries} attempts")


def text_input_to_target(
    text_input: np.ndarray,
    tokenizer,
    prompt_end_token: str,
    ignore_id: int = IGNORE_ID,
) -> np.ndarray:
    """Finetune-task helper: mask pad + prompt prefix on an already-tokenized
    sequence."""
    prompt_end_id = tokenizer.convert_tokens_to_ids(prompt_end_token)
    return _mask_target(np.asarray(text_input), tokenizer.pad_token_id, prompt_end_id, ignore_id)
