from pixparse_tpu_torch.models.bart import BartCausalDecoder, BartDecoderCfg, resolve_bart_cfg
from pixparse_tpu_torch.models.config import (
    ImageEncoderCfg,
    ModelCfg,
    TextDecoderCfg,
    get_model_config,
    list_models,
)
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.vit import ViT, ViTCfg, resolve_vit_cfg
