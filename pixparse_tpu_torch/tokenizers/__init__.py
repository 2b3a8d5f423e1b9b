"""Tokenizers (counterpart of :mod:`pixparse_tpu.tokenizers`)."""

import os

from pixparse_tpu_torch.tokenizers.bytelevel import (
    BYTELEVEL_TOKENIZER_NAME,
    BYTELEVEL_VOCAB_FILE,
    ByteLevelTokenizer,
)
from pixparse_tpu_torch.tokenizers.config import TokenizerCfg


def create_tokenizer(cfg: TokenizerCfg):
    """``pixparse_bytelevel`` -> the pure-Python byte-level tokenizer; a
    directory its ``save_pretrained`` wrote -> that tokenizer with its added
    tokens; any other name -> an HF tokenizer (``transformers`` is imported
    only here)."""
    if not cfg.name:
        raise ValueError("tokenizer name is empty")
    if cfg.name == BYTELEVEL_TOKENIZER_NAME:
        return ByteLevelTokenizer()
    if os.path.isfile(os.path.join(cfg.name, BYTELEVEL_VOCAB_FILE)):
        return ByteLevelTokenizer.from_pretrained(cfg.name)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(cfg.name)
