"""Tokenizer config (counterpart of :mod:`pixparse_tpu.tokenizers.config`)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TokenizerCfg:
    # the reference default (facebook/bart-large even for base models);
    # offline hosts use the pure-Python 'pixparse_bytelevel' tokenizer
    name: str = "facebook/bart-large"
