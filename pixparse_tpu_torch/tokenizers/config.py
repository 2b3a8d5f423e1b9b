"""Tokenizer config and its JSON registry (counterpart of
:mod:`pixparse_tpu.tokenizers.config`): each ``configs/<name>.json`` holds a
``{"tokenizer": {...}}`` entry, listed in natural order."""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from pixparse_tpu_torch.utils.name_utils import natural_key


@dataclass
class TokenizerCfg:
    # the reference default (facebook/bart-large even for base models);
    # offline hosts use the pure-Python 'pixparse_bytelevel' tokenizer
    name: str = "facebook/bart-large"


_TOKENIZER_CONFIG_DIR = Path(__file__).parent / "configs"


def _scan_tokenizer_configs() -> dict:
    configs = {}
    for cf in _TOKENIZER_CONFIG_DIR.glob("*.json"):
        with open(cf) as fh:
            configs[cf.stem] = TokenizerCfg(**json.load(fh).get("tokenizer", {}))
    return dict(sorted(configs.items(), key=lambda x: natural_key(x[0])))


_TOKENIZER_CONFIGS = _scan_tokenizer_configs()


def list_tokenizers() -> List[str]:
    return list(_TOKENIZER_CONFIGS.keys())


def get_tokenizer_config(name: str) -> Optional[TokenizerCfg]:
    if name not in _TOKENIZER_CONFIGS:
        return None
    return copy.deepcopy(_TOKENIZER_CONFIGS[name])
