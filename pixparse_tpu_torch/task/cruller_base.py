"""Shared Cruller task machinery (counterpart of
:mod:`pixparse_tpu.task.cruller_base`).

- :class:`BaseCrullerTrainTask`: tokenizer with the special-token replay
  (an HF tokenizer wrapped per loader thread), model construction (ViT,
  Swin or pix2struct encoder: ``create_cruller``; fp32 master weights, forward in
  the compute dtype, the remat mode: ``resolve_remat``, ``auto_remat``;
  a resume checkpoint, else the pretrained backbones the cfg asks for:
  ``models/pretrained.py``),
  the train state and the train step, in-step shift of the pretrain
  sequences, the gradient-accumulation buffer (images as arrays or, for
  pix2struct, dicts of arrays), counters, logging with rate
  and MFU, and a reference-``.pt``-compatible ``state_dict``.
- :class:`BaseCrullerEvalTask`: the same vocabulary replay (a checkpoint
  from before the task's tokens gets its table resized), the model (ViT
  or Swin encoder, bf16 or int8 decode mode) on the task's device in the
  compute dtype, and the KV-cached decode: greedy, or beam search when
  ``num_beams > 1``, or continuous batching over a page stream
  (:meth:`~BaseCrullerEvalTask.generate_text_stream`).

``device_preprocess`` (both halves): the host transform stops at the
resized uint8 canvas, which goes to the device as it is (a quarter of the
float32 bytes) and is normalized there in fp32
(``ops/preprocess.py::normalize_images``, the host path's bits).

Concrete tasks supply tokens, collate and metrics. Each process holds its
own slice of the global batch (the loaders split by rank) and moves it to
its device (``device_env.shard_batch``). Under a mesh the train state is
FSDP2-sharded over ``(data, fsdp)`` and the CE is a mean over the global
batch's valid tokens. Eval shards nothing over ``(data, fsdp)``: each
``(data, fsdp)`` rank decodes its own pages; with ``model > 1`` the ranks
of a model group hold the model cut over ``model`` as training cuts it
(the JAX package replicates eval parameters and splits only the
attention kernels' heads: the layouts differ, the numbers do not) and
decode the same pages together.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pixparse_tpu_torch.data.transforms import create_transforms
from pixparse_tpu_torch.framework.optimization import create_optimizer
from pixparse_tpu_torch.framework.profiling import count, span
from pixparse_tpu_torch.framework.task import StopTraining, TaskEval, TaskTrain
from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
from pixparse_tpu_torch.models.cruller import Cruller, create_cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict, load_cruller_state_dict
from pixparse_tpu_torch.models.pretrained import load_pretrained, maybe_load_pretrained
from pixparse_tpu_torch.ops.generation import generate, generate_beam
from pixparse_tpu_torch.ops.loss import IGNORE_ID, cross_entropy_from_hidden
from pixparse_tpu_torch.ops.preprocess import normalize_images
from pixparse_tpu_torch.parallel.mesh import model_parallel_size, tp_group
from pixparse_tpu_torch.task.common import add_special_tokens, fold_image_stats
from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer, TokenizerCfg, create_tokenizer
from pixparse_tpu_torch.tokenizers.thread_safe import ThreadLocalTokenizer

_logger = logging.getLogger(__name__)


def _compute_dtype(dtype_flag: Optional[str]) -> torch.dtype:
    if dtype_flag in ("bfloat16", "bf16", "float16", "fp16"):
        if dtype_flag in ("float16", "fp16"):
            _logger.warning("dtype=%s is served as bfloat16", dtype_flag)
        return torch.bfloat16
    return torch.float32


def resolve_remat(flag, auto):
    """Map the ``--task.remat`` flag (a string from the CLI, bool/str from
    code) to a model remat mode: False | True (full) | 'dots' | 'mlp' |
    'gelu' (``models/remat.py``); ``None`` and ``'auto'`` give ``auto``."""
    if flag is None:
        return auto
    if isinstance(flag, str):
        s = flag.lower()
        if s == "auto":
            return auto
        if s in ("none", "false", "0", "off"):
            return False
        if s in ("true", "full", "1", "on"):
            return True
        if s in ("dots", "mlp", "gelu"):
            return s
        raise ValueError(
            f"unknown remat mode {flag!r} "
            "(auto|none|full|dots|mlp|gelu)"
        )
    return bool(flag)


def batch_size(image) -> int:
    """Rows of a batch's image: an array, or a dict of arrays (pix2struct)."""
    return (next(iter(image.values())) if isinstance(image, dict) else image).shape[0]


def stack_batches(batches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Micro-batches -> one batch whose every array leaf is stacked on a new
    leading axis (dict-valued images leaf by leaf)."""
    first = batches[0]
    return {
        k: {n: np.stack([b[k][n] for b in batches]) for n in v} if isinstance(v, dict)
        else np.stack([b[k] for b in batches])
        for k, v in first.items()
    }


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
        embedding shapes match reference checkpoints. An HF tokenizer is
        then wrapped so each loader thread calls its own copy; the
        byte-level tokenizer holds no mutable state and stays bare."""
        tokenizer = create_tokenizer(tokenizer_cfg)
        add_special_tokens(tokenizer, base_special_tokens)
        self.vocab_size_base = len(tokenizer)
        self.newly_added_num = (
            add_special_tokens(tokenizer, finetune_special_tokens)
            if finetune_special_tokens else 0
        )
        self.vocab_size = len(tokenizer)
        if not isinstance(tokenizer, ByteLevelTokenizer):
            tokenizer = ThreadLocalTokenizer(tokenizer)
        self.tokenizer = tokenizer


# ==========================================================================
# train
# ==========================================================================

class BaseCrullerTrainTask(TaskTrain, CrullerVocabMixin):
    """One train step per batch (or per accumulation window); subclasses
    define tokens and collate."""

    task_start_token: str = ""
    prompt_end_token: str = ""
    base_special_tokens: List[str] = []
    finetune_special_tokens: Optional[List[str]] = None
    text_anno_fn: bool = False
    shift_in_step: bool = True  # pretrain shifts in train_step; finetunes in collate
    log_frequency: int = 100

    def __init__(self, cfg, device_env, monitor=None):
        super().__init__(cfg, device_env, monitor)
        self.setup_tokenizer(cfg.tokenizer, self.base_special_tokens, self.finetune_special_tokens)
        self.max_position_embeddings = cfg.model.text_decoder.max_length
        # the finetune collates tokenize to a fixed length (512 for CORD and
        # DocVQA); clamp it to the position table so a small config never
        # indexes past its positions
        if getattr(self, "collate_text_length", None):
            self.collate_text_length = min(
                type(self).collate_text_length, self.max_position_embeddings
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
        self.device_preprocess = bool(getattr(cfg, "device_preprocess", False))
        self.image_preprocess_train = create_transforms(
            getattr(cfg, "transforms", None) or "legacy",
            image_size=self.vit_cfg.img_size, training=True,
            image_mean=self.img_mean, image_std=self.img_std,
            normalize=not self.device_preprocess,
        )
        self.resume_state_dict = None
        self.model: Optional[Cruller] = None
        self._time_last = None
        self._samples_since_log = 0
        self._last_loss_dev = None  # device scalar; read only when logged
        self._flops_per_sample_step = None  # filled on the first logged batch
        self.grad_accum_steps = max(1, cfg.opt.grad_accum_steps)
        self._accum_buffer: List[Dict[str, np.ndarray]] = []

    def prepare_image(self, img) -> np.ndarray:
        """PIL image or uint8 array -> normalized float32 (H, W, C), or the
        uint8 canvas under ``device_preprocess``."""
        if hasattr(img, "convert"):  # PIL image: coerce the channel count
            img = img.convert("L" if self.num_image_chs == 1 else "RGB")
        return self.image_preprocess_train(img)

    def device_images(self, image):
        """The encoder's input from a device batch's image: a uint8 batch
        (``device_preprocess``) normalized on the device in fp32; anything
        else (float, pix2struct's dict) as it is."""
        if isinstance(image, torch.Tensor) and image.dtype == torch.uint8:
            return normalize_images(image, self.img_mean, self.img_std)
        return image

    @property
    def attn_impl(self) -> str:
        """``--task.attn_impl`` with ``auto`` resolved: the kernels on the
        card, the plain path elsewhere."""
        impl = getattr(self.cfg, "attn_impl", "auto")
        if impl == "auto":
            impl = "flash" if self.device.type == "cuda" else "xla"
        return impl

    def auto_remat(self):
        """The remat mode ``--task.remat auto`` gives: ``'mlp'`` when encoder
        tokens times encoder depth exceed 20000 (cruller_large, donut_base),
        else none."""
        return "mlp" if self.vit_cfg.num_tokens * self.vit_cfg.depth > 20000 else False

    # ------------------------------------------------------------------
    def train_setup(self, num_batches_per_interval: int, **kwargs):
        with span("setup.task"):
            cfg = self.cfg
            accum = max(1, cfg.opt.grad_accum_steps)
            self.num_steps_per_interval = num_batches_per_interval // accum
            # gradient accumulation happens inside the train step (micro-batch
            # loop, make_train_step): no accumulator in the optimizer state
            self.grad_accum_steps = accum
            self._accum_buffer = []
            self.optimizer, self.scheduler = create_optimizer(
                cfg.opt,
                num_intervals=cfg.num_intervals,
                num_warmup_intervals=cfg.num_warmup_intervals,
                updates_per_interval=max(1, self.num_steps_per_interval),
                encoder_depth=self.vit_cfg.depth,
                decoder_layers=self.bart_cfg.decoder_layers,
            )
            remat = resolve_remat(getattr(cfg, "remat", None), self.auto_remat())
            seed = kwargs.get("seed", 0)
            with span("setup.model"):
                model = create_cruller(
                    self.vit_cfg, self.bart_cfg, attn_impl=self.attn_impl,
                    compute_dtype=self.compute_dtype, remat=remat,
                )
                if self.resume_state_dict is not None:
                    load_cruller_state_dict(model, self.resume_state_dict)
                    self.resume_state_dict = None
                    _logger.info("imported torch checkpoint into train state")
                else:
                    model.init_weights(torch.Generator().manual_seed(seed))
                    # the cfg's pretrained flags (the reference defaults to pretrained
                    # backbones); raises where no weights resolve, never a silent no-op
                    pretrained = maybe_load_pretrained(cfg.model, self.vit_cfg, self.bart_cfg)
                    if pretrained:
                        load_pretrained(model, pretrained)
                        _logger.info("initialized from pretrained backbones: %s",
                                     ", ".join(pretrained))
            # fp32 master weights on the device; the forward casts at use
            with span("setup.to_device"):
                self.model = model.to(device=self.device, dtype=torch.float32).train()
            self.model.decoder.dropout_generator = torch.Generator(device=self.device)
            mesh = self.device_env.mesh
            with span("setup.train_state"):
                self.state = create_train_state(self.model, self.optimizer, seed=seed, mesh=mesh)

            def loss_fn(batch):
                # the tied table is read inside the model's call: under FSDP2 it
                # is a whole tensor only there
                hidden, table, vocab_shard = self.model.forward_hidden_head(
                    self.device_images(batch["image"]), batch["text"])
                loss, _ = cross_entropy_from_hidden(
                    hidden, table.to(hidden.dtype), batch["target"],
                    denominator=self.ce_denominator(batch["target"]), vocab_shard=vocab_shard,
                )
                return loss, {}

            self.loss_fn = loss_fn  # (device batch) -> (loss, aux): the step's loss
            self.train_step_fn = make_train_step(
                loss_fn, self.optimizer,
                reseed=self.model.decoder.reseed_dropout,
                grad_accum_steps=self.grad_accum_steps,
                mesh=mesh, module=self.model if mesh is not None else None,
            )
            self.step_idx = 0
            self.interval_batch_idx = 0
            self._flops_per_sample_step = None

    # ------------------------------------------------------------------
    def train_interval_start(self):
        if self.monitor:
            self.monitor.log_phase("train", interval=self.interval_idx, name_prefix="start ")
        self.interval_batch_idx = 0
        self._time_last = time.perf_counter()
        self._samples_since_log = 0

    def train_interval_end(self):
        if self.monitor:
            self.monitor.log_phase("train", interval=self.interval_idx)
            self.monitor.write_summary(
                {
                    "train": {
                        "step": self.step_idx,
                        "lr": self.get_current_lr(),
                        "loss": float(self._last_loss_dev)
                        if self._last_loss_dev is not None else None,
                    }
                },
                index=self.interval_idx,
            )
        self.interval_idx += 1

    # ------------------------------------------------------------------
    def normalize_batch(self, sample) -> Dict[str, np.ndarray]:
        """Task-specific batch -> ``{image, text, target}`` numpy arrays.
        Pretrain batches carry unshifted sequences and are shifted here."""
        if isinstance(sample, (tuple, list)):
            image, text, target = sample[:3]
            sample = {"image": image, "text": text, "target": target}
        image = np.asarray(sample["image"])
        if not (self.device_preprocess and image.dtype == np.uint8):
            image = image.astype(np.float32)
        text = np.asarray(sample.get("text", sample.get("label")), np.int64)
        target = np.asarray(sample.get("target", sample.get("text_target")), np.int64)
        if text.ndim == 3:  # (B, 1, L) page dimension from the OCR anno preproc
            text = text[:, 0]
            target = target[:, 0]
        if self.shift_in_step:
            text, target = text[:, :-1], target[:, 1:]
        return {
            "image": image,
            "text": text.astype(np.int32),
            "target": target.astype(np.int32),
        }

    def ce_denominator(self, target: torch.Tensor) -> Optional[torch.Tensor]:
        """What the CE divides its nll sum by. One process: ``None`` (its own
        valid count). Under a mesh: the global valid count over the ranks'
        mean, so the mean of the ranks' losses (and of their gradients, as
        FSDP2 takes it) is the global token mean of the JAX package's step."""
        mesh = self.device_env.mesh
        if mesh is None:
            return None
        from pixparse_tpu_torch.parallel.mesh import data_parallel_size, sum_over_ranks

        n_valid = sum_over_ranks(mesh, (target != IGNORE_ID).sum().float())
        return n_valid.clamp_min(1) / data_parallel_size(mesh)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Numpy batch -> tensors on the device (``device_env.shard_batch``:
        this rank's slice): token arrays as int64, the image (an array, uint8
        under ``device_preprocess``, or pix2struct's dict of arrays) as it
        is."""
        out = self.device_env.shard_batch(batch)
        return {k: v if k == "image" else v.long() for k, v in out.items()}

    def train_step(self, sample) -> Dict[str, Any]:
        if self._stop_requested:
            raise StopTraining
        with span("train.prepare"):
            batch = self.normalize_batch(sample)
        if self.grad_accum_steps > 1:
            # buffer micro-batches; one stacked device step per window
            self._accum_buffer.append(batch)
            if len(self._accum_buffer) < self.grad_accum_steps:
                self.step_idx += 1
                self.batch_idx += 1
                self.interval_batch_idx += 1
                self._samples_since_log += batch_size(batch["image"]) * self.device_env.data_size
                return {"loss": self._last_loss_dev}
            with span("train.prepare"):
                stacked = stack_batches(self._accum_buffer)
            self._accum_buffer = []
            with span("train.to_device"):
                device_batch = self._to_device(stacked)
        else:
            with span("train.to_device"):
                device_batch = self._to_device(batch)
        self.state, metrics = self.train_step_fn(self.state, device_batch)
        self._last_loss_dev = metrics["loss"]
        self.step_idx += 1
        self.batch_idx += 1
        self.interval_batch_idx += 1

        if (self.eval_frequency and self.monitor and "text" in batch
                and self.step_idx % self.eval_frequency == 0):
            self._log_train_reconstruction(batch)
        self._samples_since_log += batch_size(batch["image"]) * self.device_env.data_size

        if self.monitor and self.interval_batch_idx % self.log_frequency == 0:
            loss = float(metrics["loss"])  # the one host read, at log time
            now = time.perf_counter()
            rate = self._samples_since_log / (now - self._time_last) if self._time_last else None
            extra = {}
            if rate and "text" in batch:  # the classifier (xent) has no text
                from pixparse_tpu_torch.framework.profiling import cruller_train_flops, mfu

                if self._flops_per_sample_step is None:
                    self._flops_per_sample_step = cruller_train_flops(
                        self.vit_cfg, self.bart_cfg, 1, batch["text"].shape[1]
                    )
                # rate counts every data rank's samples (the ranks of a model
                # group share theirs): flops/s across all the devices
                util = mfu(self._flops_per_sample_step * rate, 1.0,
                           n_devices=self.device_env.world_size, device=self.device)
                if util is not None:
                    extra["mfu"] = round(util, 4)
            self._time_last = now
            self._samples_since_log = 0
            self.monitor.log_step(
                "train",
                step_idx=self.step_idx,
                step_end_idx=self.num_intervals * (self.num_steps_per_interval or 0),
                interval=self.interval_idx,
                loss=loss,
                rate=rate,
                lr=self.get_current_lr(),
                metrics=extra or None,
            )
        return {"loss": metrics["loss"]}

    # ------------------------------------------------------------------
    def _log_train_reconstruction(self, batch: Dict[str, np.ndarray]):
        """Train-time OCR reconstruction monitoring: greedy-decode a few
        pages of the current batch, log CER/WER and one image/text sample.
        A failure of the text metrics or of the logging is only warned about
        (monitoring must never kill training); the decode itself runs the
        model's kernels, whose errors propagate."""
        from pixparse_tpu_torch.utils.ocr_eval import (
            max_target_length,
            ocr_metrics_from_text,
            restore_ignored,
        )

        model = self._reconstruction_model()
        if model is None:
            return
        n = min(4, batch["image"].shape[0])  # small slice: monitoring only
        images = batch["image"][:n]
        if images.dtype == np.uint8:  # device_preprocess batches
            mean = np.asarray(self.img_mean, np.float32).reshape(1, 1, 1, -1)
            std = np.asarray(self.img_std, np.float32).reshape(1, 1, 1, -1)
            images = (images.astype(np.float32) / 255.0 - mean) / std
        text = restore_ignored(batch["text"][:n], self.tokenizer.pad_token_id)
        max_len = max_target_length(text, self.tokenizer.pad_token_id, 256)
        prompt = np.asarray(
            self.tokenizer.encode(self.task_start_token, add_special_tokens=False), np.int64
        )
        prompt = np.tile(prompt[None, :], (n, 1))
        model.eval()
        try:
            with torch.no_grad():
                enc = model.encode(torch.from_numpy(images).to(self.device))
                result = generate(
                    model, enc, torch.from_numpy(prompt).to(self.device),
                    max_length=max(max_len, prompt.shape[1] + 2),
                    eos_token_id=self.tokenizer.eos_token_id,
                    pad_token_id=self.tokenizer.pad_token_id,
                )
        finally:
            model.train()
        tokens = result.tokens.cpu().numpy().tolist()
        try:
            preds = self.tokenizer.batch_decode(tokens)
            refs = self.tokenizer.batch_decode(text.astype(np.int64).tolist())
            metrics, recon = ocr_metrics_from_text(preds, refs)
            if metrics:
                eval_data = None
                if recon:
                    eval_data = {
                        "original_text": recon["original_text"],
                        "reconstructed_text": recon["reconstructed_text"],
                        "image": images[0],
                    }
                self.monitor.log_step(
                    "train", step_idx=self.step_idx, interval=self.interval_idx,
                    phase_suffix="ocr_reconstruction", metrics=metrics, eval_data=eval_data,
                )
        except Exception as e:  # text metrics and logging only
            _logger.warning("train-time OCR reconstruction failed: %s", e)

    def _reconstruction_model(self) -> Optional[Cruller]:
        """The model the reconstruction decodes with: the training model in
        one process. Under a mesh every rank gathers the whole weights (a
        collective) and rank 0 alone decodes with a plain copy (None on the
        others): a decode's length depends on its pages, so decoding through
        the FSDP2 units would leave the ranks' collectives out of step."""
        if self.device_env.mesh is None:
            return self.model
        weights = cruller_state_dict(self.model)
        if not self.device_env.is_primary():
            return None
        model = create_cruller(self.vit_cfg, self.bart_cfg, attn_impl=self.attn_impl,
                               compute_dtype=self.compute_dtype)
        load_cruller_state_dict(model, weights)
        return model.to(self.device)

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The model weights under the reference ``.pt`` names (under a mesh
        gathered whole: every rank must call it)."""
        return cruller_state_dict(self.model)


# ==========================================================================
# eval
# ==========================================================================

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
        self.collate_text_length = min(512, self.max_position_embeddings)
        self.max_generation_length = min(
            type(self).max_generation_length, self.max_position_embeddings
        )
        self.device = device_env.device
        if cfg.kv_cache_dtype == "int8" and model_parallel_size(device_env.mesh) > 1:
            raise ValueError(  # the JAX package's refusal (ops/decode_attention.py)
                "kv_cache_dtype='int8' does not support a model-parallel "
                "mesh axis (the padded per-head scale rows don't shard on "
                "whole-head boundaries); use bf16 caches"
            )
        self.compute_dtype = _compute_dtype(cfg.dtype)
        self.num_image_chs = 1 if cfg.model.image_encoder.image_fmt == "L" else 3
        self.vit_cfg, self.bart_cfg, stats = resolve_cruller_cfgs(
            cfg.model, vocab_size=self.vocab_size
        )
        self.img_mean, self.img_std = fold_image_stats(
            stats["mean"], stats["std"], cfg.model.image_encoder.image_fmt
        )
        self.device_preprocess = bool(getattr(cfg, "device_preprocess", False))
        self.image_preprocess_eval = create_transforms(
            "legacy", image_size=self.vit_cfg.img_size, training=False,
            image_mean=self.img_mean, image_std=self.img_std,
            normalize=not self.device_preprocess,
        )
        self.resume_state_dict = None
        self.model: Optional[Cruller] = None

    def prepare_image(self, img) -> np.ndarray:
        """PIL image or uint8 array -> normalized float32 (H, W, C), or the
        uint8 canvas under ``device_preprocess``."""
        if hasattr(img, "convert"):  # PIL image: coerce the channel count
            img = img.convert("L" if self.num_image_chs == 1 else "RGB")
        return self.image_preprocess_eval(img)

    def setup(self, model_axis: bool = True):
        """Build the model, load ``resume_state_dict`` (or seeded random
        weights) and place it on the task's device in the compute dtype
        (eval holds no fp32 master weights). Under a mesh with ``model > 1``
        (and ``model_axis``) the model is then cut over the ``model`` axis
        (:func:`~pixparse_tpu_torch.parallel.tensor_parallel.parallelize`,
        no FSDP): the ranks of a model group decode the same pages, each
        with its heads, MLP columns and vocabulary rows. With
        ``model_axis=False`` every rank holds the whole model (continuous
        batching: one replica a rank)."""
        with span("setup.task"):
            attn_impl = self.cfg.attn_impl
            if attn_impl == "auto":
                attn_impl = "flash" if self.device.type == "cuda" else "xla"
            with span("setup.model"):
                model = create_cruller(
                    self.vit_cfg, self.bart_cfg, attn_impl=attn_impl,
                    kv_cache_dtype=self.cfg.kv_cache_dtype, lm_head_dtype=self.cfg.lm_head_dtype,
                )
                if self.resume_state_dict is not None:
                    load_cruller_state_dict(model, self.resume_state_dict)
                    self.resume_state_dict = None
                else:
                    model.init_weights(torch.Generator().manual_seed(0))
            with span("setup.to_device"):
                self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()
            tp = tp_group(self.device_env.mesh) if model_axis else None
            if tp is not None:
                from pixparse_tpu_torch.parallel.tensor_parallel import parallelize

                parallelize(self.model, tp)

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """(B, H, W, C) images -> encoder output on the device. Under
        ``device_preprocess`` a uint8 batch goes over as uint8 and is
        normalized there in fp32; any other batch goes over as float32."""
        with span("eval.to_device"):
            images = np.asarray(images)
            if self.device_preprocess and images.dtype == np.uint8:
                count("h2d_bytes", images.nbytes)
                x = normalize_images(
                    torch.from_numpy(images).to(self.device), self.img_mean, self.img_std)
            else:
                images = images.astype(np.float32, copy=False)
                count("h2d_bytes", images.nbytes)
                x = torch.as_tensor(images, device=self.device)
        return self.model.encode(x.to(self.compute_dtype))

    num_beams: int = 1  # > 1 switches every eval decode to beam search

    def generate_ids(self, images, prompt_ids, max_length: Optional[int] = None) -> np.ndarray:
        """Batched KV-cached decode -> (B, max_length) ids: greedy, or the
        best beam when ``num_beams > 1``."""
        enc = self.encode_images(images)
        kwargs = dict(
            max_length=max_length or self.max_generation_length,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
        )
        prompt_ids = torch.as_tensor(np.asarray(prompt_ids), device=self.device)
        if self.num_beams > 1:
            result = generate_beam(self.model, enc, prompt_ids, num_beams=self.num_beams, **kwargs)
        else:
            result = generate(self.model, enc, prompt_ids, **kwargs)
        return result.tokens.cpu().numpy()

    def generate_text(self, images, prompt_ids, max_length=None) -> List[str]:
        tokens = self.generate_ids(images, prompt_ids, max_length)
        texts = self.tokenizer.batch_decode(tokens.tolist(), skip_special_tokens=False)
        pad = self.tokenizer.pad_token
        # padding (incl. left-alignment pads of variable-length prompts)
        # never carries content
        return [t.replace(pad, "") for t in texts]

    def generate_text_stream(
        self,
        pages,  # iterable of (page_id, prepared image array)
        prompt: str,
        *,
        slots: int = 16,
        max_length: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        refill_size: int = 8,
        chunk_steps: int = 16,
        pool_pages: Optional[int] = None,
    ):
        """Continuous-batching greedy decode over a page stream
        (``ops/serving.py``): yields ``(page_id, text)`` in completion order,
        pad tokens stripped. A finished slot takes the next page, so no page
        waits for a batch's slowest one."""
        from pixparse_tpu_torch.ops.serving import ContinuousBatcher

        batcher = ContinuousBatcher(
            self.model, slots=slots, max_length=max_length or self.max_generation_length,
            prompt_ids=self.prompt_ids(prompt, 1)[0],
            eos_token_id=self.tokenizer.eos_token_id, pad_token_id=self.tokenizer.pad_token_id,
            refill_size=refill_size, chunk_steps=chunk_steps, pool_pages=pool_pages,
        )
        budget = (lambda page_id: max_new_tokens) if max_new_tokens else None
        pad = self.tokenizer.pad_token
        for res in batcher.run(pages, self.encode_images, max_new_tokens=budget):
            text = self.tokenizer.decode(res.tokens.tolist(), skip_special_tokens=False)
            yield res.page_id, text.replace(pad, "")

    def prompt_ids(self, prompt: str, batch_size: int) -> np.ndarray:
        ids = np.asarray(self.tokenizer.encode(prompt, add_special_tokens=False), np.int32)
        return np.tile(ids[None, :], (batch_size, 1))

    def average_metrics(self, metrics: Dict[int, Dict[str, float]]) -> Dict[str, float]:
        """Each key of the first batch's metrics, averaged over the batches
        that report it."""
        if not metrics:
            return {}
        keys = list(next(iter(metrics.values())).keys())
        return {
            k: float(np.mean([m[k] for m in metrics.values() if k in m])) for k in keys
        }
