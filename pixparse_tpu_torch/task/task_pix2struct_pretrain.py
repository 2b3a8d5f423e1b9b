"""Pix2Struct pretrain task (counterpart of
:mod:`pixparse_tpu.task.task_pix2struct_pretrain`).

The objective and data contract of ``cruller_pretrain`` (OCR text reading
over webdataset shards, ``<s_pretrain>`` task token), with the
variable-resolution image path: each page is patchified at its own aspect
ratio into a fixed ``max_patches`` budget (:mod:`pixparse_tpu_torch.ops.
pix2struct`, on the host) and encoded by
:class:`~pixparse_tpu_torch.models.pix2struct.Pix2StructCruller`. Batches
carry the image as the dict ``{patches, rows, cols, mask}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.ops.pix2struct import patchify_variable
from pixparse_tpu_torch.task.common import resolve_model_name
from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrain
from pixparse_tpu_torch.tokenizers import TokenizerCfg


@dataclass
class TaskPix2StructPretrainCfg(TaskTrainCfg):
    model_name: Optional[str] = "pix2struct_base"
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class TaskPix2StructPretrain(TaskCrullerPretrain):
    """``cruller_pretrain`` with the variable-resolution patch encoder: host
    patchify as the image preprocessing, the dict batch, and its own
    automatic remat rule."""

    def __init__(self, cfg: TaskPix2StructPretrainCfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        enc_cfg = self.vit_cfg  # a Pix2StructCfg, by the encoder name
        mean, std = self.img_mean, self.img_std

        def preprocess(img):
            return patchify_variable(
                np.asarray(img), enc_cfg.patch_size, enc_cfg.max_patches, mean=mean, std=std
            )

        self.image_preprocess_train = preprocess

    def auto_remat(self):
        """None under the flash kernels (no ``(B, H, N, N)`` score tensors);
        full remat on the plain path above 20000 token-layers
        (pix2struct_base: 2048 x 12)."""
        return self.attn_impl != "flash" and self.vit_cfg.num_tokens * self.vit_cfg.depth > 20000

    def train_setup(self, num_batches_per_interval: int, **kwargs):
        if self.resume_state_dict is not None:
            raise NotImplementedError("pix2struct models have no reference .pt layout to import")
        super().train_setup(num_batches_per_interval, **kwargs)

    def normalize_batch(self, sample) -> Dict[str, Any]:
        if isinstance(sample, (tuple, list)):
            image, text, target = sample[:3]
            sample = {"image": image, "text": text, "target": target}
        image = sample["image"]  # dict of (B, N, ...) arrays
        text = np.asarray(sample["text"], np.int64)
        target = np.asarray(sample["target"], np.int64)
        if text.ndim == 3:
            text, target = text[:, 0], target[:, 0]
        text, target = text[:, :-1], target[:, 1:]
        return {
            "image": {
                "patches": np.asarray(image["patches"], np.float32),
                "rows": np.asarray(image["rows"], np.int32),
                "cols": np.asarray(image["cols"], np.int32),
                "mask": np.asarray(image["mask"], bool),
            },
            "text": text.astype(np.int32),
            "target": target.astype(np.int32),
        }

    def _log_train_reconstruction(self, batch):
        pass  # the reconstruction path decodes canvas images
