"""Tokenizers (counterpart of :mod:`pixparse_tpu.tokenizers`)."""

import os

from pixparse_tpu_torch.tokenizers.bytelevel import (
    BYTELEVEL_TOKENIZER_NAME,
    BYTELEVEL_VOCAB_FILE,
    ByteLevelTokenizer,
)
from pixparse_tpu_torch.tokenizers.config import (
    TokenizerCfg,
    get_tokenizer_config,
    list_tokenizers,
)

# the JAX package's names for the offline byte-level tokenizer, which there is
# an HF fast tokenizer built in memory and here the pure-Python one
LOCAL_TOKENIZER_NAME = BYTELEVEL_TOKENIZER_NAME


def create_bytelevel_tokenizer() -> ByteLevelTokenizer:
    return ByteLevelTokenizer()


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


class TokenizerHF:
    """The tokenizer :func:`create_tokenizer` gives, held as ``trunk``."""

    def __init__(self, cfg: TokenizerCfg):
        self.trunk = create_tokenizer(cfg)
