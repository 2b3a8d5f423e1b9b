"""Task-shared vocabulary protocol + preprocessing helpers (counterpart of
:mod:`pixparse_tpu.task.common`). The special-token lists are data
contracts with reference checkpoints: token sets and addition order fix
embedding-table shapes and ids."""

from __future__ import annotations

import logging
from typing import Iterable

from pixparse_tpu_torch.models.config import get_model_config

_logger = logging.getLogger(__name__)

PRETRAIN_TASK_START = "<s_pretrain>"
SEP_TOKEN = "<sep/>"
# tokens the pretrain phase added, replayed before loading a pretrain
# checkpoint in finetune/eval tasks
SPECIAL_TOKENS_FROM_PRETRAIN = [SEP_TOKEN, PRETRAIN_TASK_START]


def add_special_tokens(tokenizer, tokens: Iterable[str]) -> int:
    """Sorted-set special-token addition (the reference's exact call
    shape). Returns the number of tokens newly added."""
    return tokenizer.add_special_tokens({"additional_special_tokens": sorted(set(tokens))})


def fold_image_stats(mean, std, image_fmt: str):
    """Grayscale stat folding: 'L' images average the per-channel stats."""
    if image_fmt == "L":
        return (sum(mean) / len(mean),), (sum(std) / len(std),)
    return tuple(mean), tuple(std)


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
