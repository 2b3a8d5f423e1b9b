"""Cross-entropy classifier finetune task (counterpart of
:mod:`pixparse_tpu.task.task_cruller_finetune_xent`).

The Cruller image encoder, its CLS token, and ``Linear(embed_dim, 16)``
trained with plain cross-entropy on RVL-CDIP labels; no text decoder. A
resume checkpoint of a Cruller gives the encoder only (the head starts
fresh). ``state_dict`` has the JAX task's layout: ``encoder.trunk.*`` and
``final_fc.{weight,bias}``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pixparse_tpu_torch.framework.config import TaskTrainCfg
from pixparse_tpu_torch.framework.optimization import create_optimizer
from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
from pixparse_tpu_torch.models.config import ModelCfg
from pixparse_tpu_torch.models.interop import ENC_PREFIX, cruller_state_dict, normalize_state_dict
from pixparse_tpu_torch.models.vit import ViT
from pixparse_tpu_torch.task.common import (
    SPECIAL_TOKENS_FROM_PRETRAIN,
    resolve_model_name,
    stack_images,
)
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask
from pixparse_tpu_torch.tokenizers import TokenizerCfg

_logger = logging.getLogger(__name__)

NUM_CLASSES = 16  # RVL-CDIP


@dataclass
class TaskCrullerFinetuneXentCfg(TaskTrainCfg):
    model_name: Optional[str] = None
    model: ModelCfg = field(default_factory=ModelCfg)
    tokenizer: TokenizerCfg = field(default_factory=TokenizerCfg)

    def __post_init__(self):
        resolve_model_name(self)


class CrullerClassifier(nn.Module):
    """encoder -> CLS token -> ``final_fc`` (fp32 logits). The encoder runs
    in ``compute_dtype``; ``attn_impl`` as :class:`~pixparse_tpu_torch.models.vit.ViT`'s."""

    def __init__(self, vit_cfg, num_classes: int = NUM_CLASSES, attn_impl: str = "xla",
                 compute_dtype=None):
        super().__init__()
        self.encoder = nn.ModuleDict({"trunk": ViT(vit_cfg, attn_impl, compute_dtype)})
        self.final_fc = nn.Linear(vit_cfg.embed_dim, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CrullerClassifier":
        """The encoder's JAX init; the head as flax's ``Dense`` default
        (lecun-normal kernel: truncated normal of std 1/sqrt(fan_in), zero
        bias)."""
        self.encoder["trunk"].init_weights(generator)
        std = (1.0 / self.final_fc.in_features) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.final_fc.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        nn.init.zeros_(self.final_fc.bias)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cls = self.encoder["trunk"](images)[:, 0, :]
        return self.final_fc(cls.float())


def load_encoder_from_cruller(model: CrullerClassifier, state_dict) -> None:
    """The encoder of a Cruller checkpoint (``image_encoder.trunk.*``),
    strictly; the head stays as it is."""
    sd = normalize_state_dict(state_dict)
    enc = {k[len(ENC_PREFIX):]: v for k, v in sd.items() if k.startswith(ENC_PREFIX)}
    model.encoder["trunk"].load_state_dict(enc, strict=True)


class TaskCrullerFinetuneXent(BaseCrullerTrainTask):
    task_start_token = "<s_pretrain>"
    prompt_end_token = "<s_pretrain>"
    base_special_tokens = SPECIAL_TOKENS_FROM_PRETRAIN
    finetune_special_tokens = None
    text_anno_fn = True
    shift_in_step = False
    collate_text_length = 2  # unused: no text

    def collate_fn(self, batch):
        images = [self.prepare_image(item["image"]) for item in batch]
        labels = np.asarray([int(item["label"]) for item in batch], np.int32)
        return {"image": stack_images(images), "label": labels}

    def train_setup(self, num_batches_per_interval: int, **kwargs):
        cfg = self.cfg
        accum = max(1, cfg.opt.grad_accum_steps)
        self.grad_accum_steps = accum
        self._accum_buffer = []
        self.num_steps_per_interval = num_batches_per_interval // accum
        self.optimizer, self.scheduler = create_optimizer(
            cfg.opt,
            num_intervals=cfg.num_intervals,
            num_warmup_intervals=cfg.num_warmup_intervals,
            updates_per_interval=max(1, self.num_steps_per_interval),
            encoder_depth=self.vit_cfg.depth,
            decoder_layers=0,
        )
        seed = kwargs.get("seed", 0)
        model = CrullerClassifier(
            self.vit_cfg, attn_impl=self.attn_impl, compute_dtype=self.compute_dtype
        )
        model.init_weights(torch.Generator().manual_seed(seed))
        if self.resume_state_dict is not None:
            load_encoder_from_cruller(model, self.resume_state_dict)
            self.resume_state_dict = None
            _logger.info("imported encoder weights from a Cruller checkpoint")
        self.model = model.to(device=self.device, dtype=torch.float32).train()
        mesh = self.device_env.mesh
        self.state = create_train_state(self.model, self.optimizer, seed=seed, mesh=mesh)

        def loss_fn(batch):
            # a mean over the rank's rows: under a mesh the ranks hold equal
            # batches, so the mean over the ranks is the global mean
            logits = self.model(self.device_images(batch["image"]))
            labels = batch["label"]
            true_logit = logits.gather(-1, labels[:, None])[:, 0]
            loss = (torch.logsumexp(logits, dim=-1) - true_logit).mean()
            accuracy = (logits.argmax(-1) == labels).float().mean()
            return loss, {"accuracy": accuracy.detach()}

        self.loss_fn = loss_fn
        self.train_step_fn = make_train_step(
            loss_fn, self.optimizer, grad_accum_steps=accum,
            mesh=mesh, module=self.model if mesh is not None else None)
        self.step_idx = 0
        self.interval_batch_idx = 0
        self._flops_per_sample_step = None

    def normalize_batch(self, sample) -> Dict[str, np.ndarray]:
        """Under ``device_preprocess`` the uint8 canvases stay uint8 and the
        loss normalizes them on the device (the JAX task casts them to
        float32 and trains on unnormalized pixels)."""
        image = np.asarray(sample["image"])
        if not (self.device_preprocess and image.dtype == np.uint8):
            image = image.astype(np.float32)
        return {"image": image, "label": np.asarray(sample["label"], np.int32)}

    def state_dict(self) -> Dict[str, Any]:
        """``encoder.trunk.*`` and ``final_fc.{weight,bias}``, fp32 CPU."""
        return cruller_state_dict(self.model)
