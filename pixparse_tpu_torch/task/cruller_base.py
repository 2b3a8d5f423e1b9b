"""Shared Cruller eval-task machinery (counterpart of
:mod:`pixparse_tpu.task.cruller_base`; the train task arrives with the
training slice).

:class:`BaseCrullerEvalTask` builds the tokenizer with the special-token
replay, the model on the task's device in the compute dtype, and the
KV-cached greedy decode; concrete tasks supply tokens and metrics. There is
one device and no mesh, so eval batches go to the device as they are.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from pixparse_tpu_torch.data.transforms import create_transforms
from pixparse_tpu_torch.framework.task import TaskEval
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import load_cruller_state_dict
from pixparse_tpu_torch.ops.generation import generate
from pixparse_tpu_torch.task.common import add_special_tokens, fold_image_stats
from pixparse_tpu_torch.tokenizers import TokenizerCfg, create_tokenizer

_logger = logging.getLogger(__name__)


def _compute_dtype(dtype_flag: Optional[str]) -> torch.dtype:
    if dtype_flag in ("bfloat16", "bf16", "float16", "fp16"):
        if dtype_flag in ("float16", "fp16"):
            _logger.warning("dtype=%s is served as bfloat16", dtype_flag)
        return torch.bfloat16
    return torch.float32


class CrullerVocabMixin:
    """Tokenizer + special-token replay, shared by the Cruller tasks."""

    def setup_tokenizer(
        self,
        tokenizer_cfg: TokenizerCfg,
        base_special_tokens: List[str],
        finetune_special_tokens: Optional[List[str]] = None,
    ):
        """Replay the reference's token-addition history: base (pretrain)
        tokens first, then optional finetune tokens, so token ids and
        embedding shapes match reference checkpoints."""
        tokenizer = create_tokenizer(tokenizer_cfg)
        add_special_tokens(tokenizer, base_special_tokens)
        self.vocab_size_base = len(tokenizer)
        self.newly_added_num = (
            add_special_tokens(tokenizer, finetune_special_tokens)
            if finetune_special_tokens else 0
        )
        self.vocab_size = len(tokenizer)
        self.tokenizer = tokenizer


class BaseCrullerEvalTask(TaskEval, CrullerVocabMixin):
    task_start_token: str = ""
    prompt_end_token: str = ""
    base_special_tokens: List[str] = []
    finetune_special_tokens: Optional[List[str]] = None
    max_generation_length: int = 512

    def __init__(self, cfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.setup_tokenizer(cfg.tokenizer, self.base_special_tokens, self.finetune_special_tokens)
        self.max_position_embeddings = cfg.model.text_decoder.max_length
        self.max_generation_length = min(
            type(self).max_generation_length, self.max_position_embeddings
        )
        self.device = device_env.device
        self.compute_dtype = _compute_dtype(cfg.dtype)
        self.num_image_chs = 1 if cfg.model.image_encoder.image_fmt == "L" else 3
        self.vit_cfg, self.bart_cfg, stats = resolve_cruller_cfgs(
            cfg.model, vocab_size=self.vocab_size
        )
        self.img_mean, self.img_std = fold_image_stats(
            stats["mean"], stats["std"], cfg.model.image_encoder.image_fmt
        )
        self.image_preprocess_eval = create_transforms(
            "legacy", image_size=self.vit_cfg.img_size, training=False,
            image_mean=self.img_mean, image_std=self.img_std,
        )
        self.resume_state_dict = None
        self.model: Optional[Cruller] = None

    def prepare_image(self, img) -> np.ndarray:
        """PIL image or uint8 array -> normalized float32 (H, W, C)."""
        if hasattr(img, "convert"):  # PIL image: coerce the channel count
            img = img.convert("L" if self.num_image_chs == 1 else "RGB")
        return self.image_preprocess_eval(img)

    def setup(self):
        """Build the model, load ``resume_state_dict`` (or seeded random
        weights) and place it on the task's device in the compute dtype
        (eval holds no fp32 master weights)."""
        attn_impl = self.cfg.attn_impl
        if attn_impl == "auto":
            attn_impl = "flash" if self.device.type == "cuda" else "xla"
        model = Cruller(
            self.vit_cfg, self.bart_cfg, attn_impl=attn_impl,
            kv_cache_dtype=self.cfg.kv_cache_dtype, lm_head_dtype=self.cfg.lm_head_dtype,
        )
        if self.resume_state_dict is not None:
            load_cruller_state_dict(model, self.resume_state_dict)
            self.resume_state_dict = None
        else:
            model.init_weights(torch.Generator().manual_seed(0))
        self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """(B, H, W, C) normalized float images -> encoder output on device."""
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return self.model.encode(images.to(self.compute_dtype))

    def generate_ids(self, images, prompt_ids, max_length: Optional[int] = None) -> np.ndarray:
        """Batched KV-cached greedy decode -> (B, max_length) ids."""
        enc = self.encode_images(images)
        result = generate(
            self.model,
            enc,
            torch.as_tensor(np.asarray(prompt_ids), device=self.device),
            max_length=max_length or self.max_generation_length,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
        )
        return result.tokens.cpu().numpy()

    def generate_text(self, images, prompt_ids, max_length=None) -> List[str]:
        tokens = self.generate_ids(images, prompt_ids, max_length)
        texts = self.tokenizer.batch_decode(tokens.tolist(), skip_special_tokens=False)
        pad = self.tokenizer.pad_token
        # padding (incl. left-alignment pads of variable-length prompts)
        # never carries content
        return [t.replace(pad, "") for t in texts]

    def prompt_ids(self, prompt: str, batch_size: int) -> np.ndarray:
        ids = np.asarray(self.tokenizer.encode(prompt, add_special_tokens=False), np.int32)
        return np.tile(ids[None, :], (batch_size, 1))
