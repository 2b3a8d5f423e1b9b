"""Batch inference CLI: ``python -m pixparse_tpu_torch.app.infer``
(counterpart of :mod:`pixparse_tpu.app.infer`, the serving entry point).

Takes a directory / glob of page images, batches them through the
KV-cached greedy decode on the CUDA card (``--task.device cpu`` to run on
the CPU) and writes one JSON line ``{"file", "text"}`` per page (the
JSON-completion tasks ``cruller_eval_{cord,docvqa,rvlcdip}`` add the
parsed ``"json"``, by ``token2json``):

    python -m pixparse_tpu_torch.app.infer \\
        --infer.task_name cruller_eval_ocr \\
        --infer.checkpoint_path ./checkpoint-29.pt \\
        --infer.images './pages/*.png' \\
        --infer.output ./ocr.jsonl \\
        --task.model_name cruller_base --task.dtype bfloat16

Tasks: the Cruller eval tasks (``donut_eval_ocr`` runs in ``app.eval``
only, as in the JAX package). The final partial batch is padded
(repeat-last) to the batch size, as in the JAX package. ``--infer.continuous true`` (continuous batching) is not
ported yet.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from dataclasses import dataclass, replace
from typing import List, Optional

from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework import random_seed, setup_logging
from pixparse_tpu_torch.framework.cli import ConfigArgumentParser, peek_flag
from pixparse_tpu_torch.task.cruller_base import BaseCrullerEvalTask
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY

_logger = logging.getLogger("infer")

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".webp")


@dataclass
class InferCfg:
    task_name: str = "cruller_eval_ocr"
    checkpoint_path: str = ""
    images: str = ""  # directory or glob of page images
    output: str = ""  # output JSONL path ('' or '-' = stdout)
    batch_size: int = 16
    max_new_tokens: int = 0  # 0 = task default generation length
    prompt: str = ""  # override the task prompt token/text
    seed: int = 42
    # continuous batching and its knobs: flags kept, not ported yet
    continuous: bool = False
    refill_size: int = 0
    chunk_steps: int = 16
    pool_pages: int = 0


def _list_images(spec: str) -> List[str]:
    if os.path.isdir(spec):
        files = [
            os.path.join(spec, f)
            for f in sorted(os.listdir(spec))
            if f.lower().endswith(_IMAGE_EXTS)
        ]
    else:
        files = sorted(glob.glob(spec))
    if not files:
        raise FileNotFoundError(f"no images match {spec!r}")
    return files


def _maybe_json(text: str) -> Optional[dict]:
    """Generated markup parsed into a dict, or None (a malformed generation
    keeps only its raw text)."""
    from pixparse_tpu_torch.utils.json_utils import token2json

    try:
        out = token2json(text)
    except Exception:  # noqa: BLE001 -- any parse failure: raw text only
        return None
    return out if out else None


def infer(infer_cfg: InferCfg, task_cfg) -> int:
    if infer_cfg.continuous:
        raise NotImplementedError(
            "--infer.continuous: continuous batching (ops/serving.py) is not "
            "ported yet (ROADMAP.md Queue 1)"
        )
    import torch

    env = DeviceEnv.initialize(task_cfg.device)
    random_seed(infer_cfg.seed, env.global_rank)
    task_cls, _ = TASK_CLASS_REGISTRY[infer_cfg.task_name]
    task = task_cls(task_cfg, env, None)

    if infer_cfg.checkpoint_path:
        checkpoint = torch.load(infer_cfg.checkpoint_path, map_location="cpu", weights_only=False)
        if isinstance(checkpoint, dict) and "model" in checkpoint:
            checkpoint = checkpoint["model"]
        task.resume_state_dict = checkpoint
        _logger.info("loaded checkpoint %s", infer_cfg.checkpoint_path)
    else:
        _logger.warning("no --infer.checkpoint_path: running random weights")
    task.setup()

    files = _list_images(infer_cfg.images)
    _logger.info("%d images on %s", len(files), env)
    bs = max(1, infer_cfg.batch_size)
    prompt = infer_cfg.prompt or task.task_start_token
    emit_json = infer_cfg.task_name != "cruller_eval_ocr"

    def _record(f: str, text: str) -> dict:
        # strip only the structural frame -- the leading prompt and the
        # trailing EOS -- never interior occurrences of either string
        if prompt and text.startswith(prompt):
            text = text[len(prompt):]
        eos = task.tokenizer.eos_token or ""
        if eos and text.endswith(eos):
            text = text[: -len(eos)]
        rec = {"file": f, "text": text.strip()}
        if emit_json:
            parsed = _maybe_json(rec["text"])
            if parsed is not None:
                rec["json"] = parsed
        return rec

    records = _infer_batched(infer_cfg, task, files, prompt, bs, _record)
    lines = [json.dumps(r, ensure_ascii=False) for r in records]
    out = infer_cfg.output
    if env.is_primary():
        if out and out != "-":
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                f.write("\n".join(lines) + "\n")
            _logger.info("wrote %s (%d records)", out, len(records))
        else:
            for line in lines:
                print(line)
    task.end()
    return 0


def _infer_batched(infer_cfg, task, files, prompt, bs, _record):
    import numpy as np
    from PIL import Image

    records = []
    for lo in range(0, len(files), bs):
        chunk = files[lo:lo + bs]
        n = len(chunk)
        padded = chunk + [chunk[-1]] * (bs - n)
        images = np.stack([task.prepare_image(Image.open(f)) for f in padded])
        prompt_ids = task.prompt_ids(prompt, bs)
        # max_new_tokens counts generated tokens; generate() takes the total
        # sequence length (prompt included)
        max_len = (
            prompt_ids.shape[1] + infer_cfg.max_new_tokens if infer_cfg.max_new_tokens else None
        )
        texts = task.generate_text(images, prompt_ids, max_length=max_len)[:n]
        records.extend(_record(f, text) for f, text in zip(chunk, texts))
        _logger.info("%d/%d pages done", min(lo + bs, len(files)), len(files))
    return records


def main(argv=None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    task_name = peek_flag(argv, "infer.task_name") or "cruller_eval_ocr"
    eval_tasks = sorted(
        n for n, (cls, _) in TASK_CLASS_REGISTRY.items() if issubclass(cls, BaseCrullerEvalTask)
    )
    if task_name not in eval_tasks:
        raise SystemExit(f"--infer.task_name must be one of {eval_tasks}")
    _, task_cfg_cls = TASK_CLASS_REGISTRY[task_name]

    parser = ConfigArgumentParser(description="pixparse_tpu_torch batch inference")
    parser.add_arguments(InferCfg, dest="infer")
    parser.add_arguments(task_cfg_cls, dest="task")
    args = parser.parse_args(argv)
    infer_cfg: InferCfg = replace(args.infer, task_name=task_name)

    setup_logging(None)
    return infer(infer_cfg, args.task)


if __name__ == "__main__":
    raise SystemExit(main())
