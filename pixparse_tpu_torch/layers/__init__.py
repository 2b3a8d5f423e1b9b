"""The building blocks the models are made of, re-exported (counterpart of
:mod:`pixparse_tpu.layers`, under its names: the port's ViT attention, block
and MLP are ``models/vit.py``'s ``Attention``, ``Block`` and ``Mlp``)."""

from pixparse_tpu_torch.models.bart import (
    BartDecoderLayer,
    CachedCrossAttention,
    CachedSelfAttention,
)
from pixparse_tpu_torch.models.swin import PatchMerging, SwinBlock, WindowAttention
from pixparse_tpu_torch.models.vit import Attention as ViTAttention
from pixparse_tpu_torch.models.vit import Block as ViTBlock
from pixparse_tpu_torch.models.vit import Mlp as ViTMlp
from pixparse_tpu_torch.ops.attention import dot_product_attention, make_attention_bias
from pixparse_tpu_torch.ops.flash_attention import flash_attention
