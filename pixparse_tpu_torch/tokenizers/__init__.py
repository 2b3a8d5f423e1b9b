"""Tokenizers (counterpart of :mod:`pixparse_tpu.tokenizers`)."""

from pixparse_tpu_torch.tokenizers.bytelevel import BYTELEVEL_TOKENIZER_NAME, ByteLevelTokenizer
from pixparse_tpu_torch.tokenizers.config import TokenizerCfg


def create_tokenizer(cfg: TokenizerCfg):
    """``pixparse_bytelevel`` -> the pure-Python byte-level tokenizer; any
    other name -> an HF tokenizer (``transformers`` is imported only here)."""
    if not cfg.name:
        raise ValueError("tokenizer name is empty")
    if cfg.name == BYTELEVEL_TOKENIZER_NAME:
        return ByteLevelTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(cfg.name)
