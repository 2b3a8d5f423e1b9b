"""Model config dataclasses + JSON registry (counterpart of
:mod:`pixparse_tpu.models.config`). The registry scans this package's own
``models/configs/*.json`` at import, natural-sorted, deep-copied on get."""

from __future__ import annotations

import copy
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

from pixparse_tpu_torch.utils.name_utils import natural_key

_logger = logging.getLogger(__name__)


@dataclass
class ImageEncoderCfg:
    name: str = "vit_base_patch16_224"
    image_fmt: str = "L"
    image_size: Optional[Tuple[int, int]] = (576, 448)
    pretrained: bool = False
    pretrained_path: Optional[str] = None


@dataclass
class TextDecoderCfg:
    name: str = "facebook/bart-base"
    pretrained: bool = False
    pretrained_path: Optional[str] = None
    num_decoder_layers: Optional[int] = 4
    max_length: Optional[int] = 1024
    pad_token_id: Optional[int] = None


@dataclass
class ModelCfg:
    image_encoder: ImageEncoderCfg = field(default_factory=ImageEncoderCfg)
    text_decoder: TextDecoderCfg = field(default_factory=TextDecoderCfg)


_MODEL_CONFIG_DIR = Path(__file__).parent / "configs"


def _load_model_cfg(d: dict) -> ModelCfg:
    enc = d.get("image_encoder", {})
    dec = d.get("text_decoder", {})
    if enc.get("image_size") is not None:
        enc = dict(enc, image_size=tuple(enc["image_size"]))
    return ModelCfg(
        image_encoder=ImageEncoderCfg(**enc),
        text_decoder=TextDecoderCfg(**dec),
    )


def _scan_model_configs() -> dict:
    configs = {}
    for cf in _MODEL_CONFIG_DIR.glob("*.json"):
        with open(cf) as fh:
            configs[cf.stem] = _load_model_cfg(json.load(fh))
    return dict(sorted(configs.items(), key=lambda x: natural_key(x[0])))


_MODEL_CONFIGS = _scan_model_configs()


def list_models() -> List[str]:
    return list(_MODEL_CONFIGS.keys())


def get_model_config(model_name: str) -> Optional[ModelCfg]:
    if model_name not in _MODEL_CONFIGS:
        return None
    return copy.deepcopy(_MODEL_CONFIGS[model_name])
