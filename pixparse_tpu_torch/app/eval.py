"""Eval CLI: ``python -m pixparse_tpu_torch.app.eval`` (counterpart of
:mod:`pixparse_tpu.app.eval`).

Flow: device -> TaskFactory -> seeded RNG -> logging and Monitor under
``--eval.output_dir`` -> the local ``.pt`` checkpoint -> metrics file name
from the checkpoint path and dataset name (``donut_eval_ocr``: no
checkpoint, ``{task}-{dataset}-metrics.json``) -> one loader per
``--eval.datasets`` entry -> ``task.setup()`` -> ``evaluate`` -> the metrics
JSON -> ``task.end()``::

    python -m pixparse_tpu_torch.app.eval \\
        --eval.task_name cruller_eval_ocr \\
        --eval.checkpoint_path ./checkpoint-29.pt \\
        --eval.dataset_name FUNSD --eval.output_dir ./eval \\
        --task.model_name cruller_base --task.dtype bfloat16 \\
        --data.eval.source 'funsd-{000..003}.tar' --data.eval.num_samples 50 \\
        --data.eval.batch_size 16 --data.eval.split eval

Tasks: ``cruller_eval_ocr`` and ``cruller_eval_{cord,docvqa,rvlcdip}``
(those three read ``--data.eval.format hf_dataset``: ``--data.eval.source
SinglePageDocVQA`` from ``$PIXPARSE_DOCVQA_DIR`` with ``--data.eval.split
val``, or a ``datasets.load_dataset`` source). One process on one device:
``--task.device`` (default ``cuda``; without a card that raises,
``--task.device cpu`` asks for the CPU). ``--eval.s3_bucket`` raises (the
port reads local checkpoints only). ``donut_eval_ocr``, the HF Donut
baseline, takes ``--task.model_name`` as a local model directory (or a name
in the HF cache) and needs ``transformers``.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field, replace
from typing import List

from pixparse_tpu_torch.data import DataCfg, create_loader
from pixparse_tpu_torch.data.wds import create_image_text_pipe
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework import Monitor, evaluate, random_seed, setup_logging
from pixparse_tpu_torch.framework.cli import ConfigArgumentParser, peek_flag
from pixparse_tpu_torch.framework.task import TaskEval
from pixparse_tpu_torch.models.interop import load_torch_checkpoint
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory

_logger = logging.getLogger("eval")


@dataclass
class EvalCfg:
    experiment: str = ""
    output_dir: str = "./output"
    log_filename: str = "out.log"
    dataset_name: str = ""
    s3_bucket: str = ""
    checkpoint_path: str = ""
    metrics_file_path: str = ""
    task_name: str = ""
    datasets: List[str] = field(default_factory=lambda: ["eval"])
    seed: int = 42


def metrics_file_name(checkpoint_path: str, dataset_name: str) -> str:
    """``{checkpoint path with / -> _, minus .pt}-{dataset}-metrics.json``."""
    checkpoint_name = checkpoint_path.replace("/", "_").replace(".pt", "")
    return f"{checkpoint_name}-{dataset_name}-metrics.json"


def main(argv=None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    task_name = peek_flag(argv, "eval.task_name")
    eval_tasks = sorted(
        n for n, (cls, _) in TASK_CLASS_REGISTRY.items() if issubclass(cls, TaskEval)
    )
    if task_name not in eval_tasks:
        raise SystemExit(f"--eval.task_name must be one of {eval_tasks}")
    _, task_cfg_cls = TASK_CLASS_REGISTRY[task_name]

    parser = ConfigArgumentParser(description="pixparse_tpu_torch eval")
    parser.add_arguments(EvalCfg, dest="eval")
    parser.add_arguments(task_cfg_cls, dest="task")
    parser.add_arguments(DataCfg, dest="data")
    args = parser.parse_args(argv)
    eval_cfg: EvalCfg = args.eval
    data_cfg: DataCfg = args.data

    # raises when CUDA is asked for (the default) and there is none
    device_env = DeviceEnv.initialize(args.task.device)
    task, task_cfg = TaskFactory.create_task(
        task_name=eval_cfg.task_name, task_args=args.task, device_env=device_env, monitor=None,
    )
    random_seed(eval_cfg.seed, rank=device_env.global_rank)
    _logger.info(f"Device env is {device_env}")

    os.makedirs(eval_cfg.output_dir, exist_ok=True)
    setup_logging(os.path.join(eval_cfg.output_dir, eval_cfg.log_filename))
    task.monitor = Monitor(
        eval_cfg.experiment, output_dir=eval_cfg.output_dir,
        output_enabled=device_env.is_primary(),
    )

    if eval_cfg.task_name == "donut_eval_ocr":  # the HF model brings its weights
        file_name = f"{eval_cfg.task_name}-{eval_cfg.dataset_name}-metrics.json"
    else:
        if eval_cfg.s3_bucket != "":
            raise NotImplementedError(
                "--eval.s3_bucket: loading checkpoints from S3 is not ported (it needs "
                "network access); copy the checkpoint to a local path"
            )
        if not os.path.isfile(eval_cfg.checkpoint_path):
            raise FileNotFoundError(f"Cannot find checkpoint {eval_cfg.checkpoint_path!r}")
        task.resume_state_dict = load_torch_checkpoint(eval_cfg.checkpoint_path)
        file_name = metrics_file_name(eval_cfg.checkpoint_path, eval_cfg.dataset_name)
    eval_cfg = replace(eval_cfg, metrics_file_path=os.path.join(eval_cfg.output_dir, file_name))
    _logger.info(task_cfg)
    _logger.info(eval_cfg)

    if data_cfg.eval is None:
        raise ValueError("the eval app requires --data.eval.*")
    loaders = {
        name: create_loader(
            data_cfg.eval,
            is_train=False,
            collate_fn=task.collate_fn,
            image_preprocess=getattr(task, "image_preprocess_eval", None),
            anno_preprocess=getattr(task, "anno_preprocess_eval", None),
            image_fmt=task_cfg.model.image_encoder.image_fmt,
            seed=eval_cfg.seed,
            world_size=device_env.world_size,
            global_rank=device_env.global_rank,
            create_decoder_pipe=create_image_text_pipe,
        )
        # one loader per dataset identifier; the task keeps those it evaluates
        for name in (eval_cfg.datasets or ["eval"])
    }

    task.setup()
    metrics = evaluate(task, loaders)
    if device_env.is_primary():
        with open(eval_cfg.metrics_file_path, "w") as fh:
            json.dump(metrics, fh)
    _logger.info("eval metrics: %s", metrics)
    task.end()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
