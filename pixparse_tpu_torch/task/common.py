"""Task-shared vocabulary protocol + preprocessing helpers (counterpart of
:mod:`pixparse_tpu.task.common`). The special-token lists are data
contracts with reference checkpoints: token sets and addition order fix
embedding-table shapes and ids."""

from __future__ import annotations

import logging
from typing import Iterable, List

import numpy as np

from pixparse_tpu_torch.models.config import get_model_config

_logger = logging.getLogger(__name__)

PRETRAIN_TASK_START = "<s_pretrain>"
SEP_TOKEN = "<sep/>"
# tokens the pretrain phase added, replayed before loading a pretrain
# checkpoint in finetune/eval tasks
SPECIAL_TOKENS_FROM_PRETRAIN = [SEP_TOKEN, PRETRAIN_TASK_START]

# the CORD field tokens (56 entries; additions are sorted-set, the list is
# kept in the reference's order)
CORD_FINETUNE_TOKENS = [
    SEP_TOKEN,
    "<s_cord>",
    "</s_service_price>", "<s_subtotal_price>", "<s_discountprice>", "</s_sub>",
    "<s_sub>", "</s_total_etc>", "</s_discountprice>", "</s_vatyn>",
    "</s_subtotal_price>", "<s_changeprice>", "</s_total>", "</s_unitprice>",
    "<s_emoneyprice>", "</s_tax_price>", "</s_othersvc_price>", "</s_cnt>",
    "<s_vatyn>", "<s_unitprice>", "<s_total>", "<s_price>", "</s_price>",
    "<s_sub_total>", "</s_num>", "<s_total_etc>", "</s_creditcardprice>",
    "<s_tax_price>", "<s_menu>", "<s_nm>", "<s_menutype_cnt>",
    "</s_changeprice>", "<s_num>", "<s_itemsubtotal>", "</s_etc>",
    "<s_creditcardprice>", "</s_menuqty_cnt>", "</s_emoneyprice>",
    "<s_menuqty_cnt>", "<s_discount_price>", "</s_menu>", "</s_sub_total>",
    "<s_etc>", "</s_void_menu>", "<s_cashprice>", "</s_discount_price>",
    "</s_total_price>", "</s_nm>", "<s_service_price>", "<s_othersvc_price>",
    "</s_itemsubtotal>", "<s_void_menu>", "<s_total_price>", "</s_cashprice>",
    "</s_menutype_cnt>", "<s_cnt>",
]

# the RVL-CDIP class tokens
RVLCDIP_FINETUNE_TOKENS = [
    SEP_TOKEN,
    "<s_rvlcdip>",
    "<s_class>", "</s_class>",
    "<advertisement/>", "<budget/>", "<email/>", "<file_folder/>", "<form/>",
    "<handwritten/>", "<invoice/>", "<letter/>", "<memo/>", "<news_article/>",
    "<presentation/>", "<questionnaire/>", "<resume/>",
    "<scientific_publication/>", "<scientific_report/>", "<specification/>",
]

# RVL-CDIP label -> class name
RVLCDIP_INT2STR = {
    0: "letter", 1: "form", 2: "email", 3: "handwritten", 4: "advertisement",
    5: "scientific_report", 6: "scientific_publication", 7: "specification",
    8: "file_folder", 9: "news_article", 10: "budget", 11: "invoice",
    12: "presentation", 13: "questionnaire", 14: "resume", 15: "memo",
}

# the DocVQA prompt and answer tags
DOCVQA_FINETUNE_TOKENS = [
    SEP_TOKEN,
    "<s_docvqa>", "<s_answer>",
    "<s_question>", "</s_question>", "</s_answer>",
]


def add_special_tokens(tokenizer, tokens: Iterable[str]) -> int:
    """Sorted-set special-token addition (the reference's exact call
    shape). Returns the number of tokens newly added."""
    return tokenizer.add_special_tokens({"additional_special_tokens": sorted(set(tokens))})


def fold_image_stats(mean, std, image_fmt: str):
    """Grayscale stat folding: 'L' images average the per-channel stats."""
    if image_fmt == "L":
        return (sum(mean) / len(mean),), (sum(std) / len(std),)
    return tuple(mean), tuple(std)


def batch_images(images) -> np.ndarray:
    """An NHWC image batch as the model takes it from the host: uint8
    canvases (``device_preprocess``: normalized on the device) stay uint8,
    anything else becomes float32. The JAX package casts every batch to
    float32, so its ``device_preprocess`` canvases reach the encoder
    unnormalized in the eval and finetune tasks."""
    images = np.asarray(images)
    return images if images.dtype == np.uint8 else images.astype(np.float32)


def stack_images(images: List[np.ndarray]) -> np.ndarray:
    """Stack transformed (H, W, C) images into an NHWC batch
    (:func:`batch_images`' dtype)."""
    return batch_images(np.stack([np.asarray(im) for im in images], axis=0))


def tokenize_batch(tokenizer, texts: List[str], max_length: int) -> np.ndarray:
    """Fixed-shape batched tokenization (the finetune collates): each text
    without special tokens, right-padded and truncated to ``max_length``
    -> (B, max_length) int32."""
    rows = [
        tokenizer(
            text, add_special_tokens=False, return_tensors="np", max_length=max_length,
            padding="max_length", truncation=True,
        ).input_ids[0]
        for text in texts
    ]
    return np.stack(rows).astype(np.int32)


def resolve_model_name(cfg) -> None:
    """Shared ``__post_init__`` body for task cfg dataclasses: resolve
    ``model_name`` through the JSON registry into ``cfg.model``. The
    ``pretrained`` / ``pretrained_path`` flags given beside ``model_name``
    (``--task.model.image_encoder.pretrained true``) are kept: an asked-for
    backbone is never dropped for random weights. (The JAX package replaces
    the whole ``cfg.model`` and drops them.)"""
    if cfg.model_name:
        model = get_model_config(cfg.model_name)
        if model is None:
            _logger.warning(f"Model config for {cfg.model_name} was not found, using defaults.")
        else:
            for part in ("image_encoder", "text_decoder"):
                given, registered = getattr(cfg.model, part), getattr(model, part)
                registered.pretrained = registered.pretrained or given.pretrained
                registered.pretrained_path = given.pretrained_path or registered.pretrained_path
            cfg.model = model
    else:
        cfg.model_name = "custom"
