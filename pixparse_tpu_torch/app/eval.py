"""Eval CLI: ``python -m pixparse_tpu_torch.app.eval`` (counterpart of
:mod:`pixparse_tpu.app.eval`).

Flow: device -> TaskFactory -> seeded RNG -> logging and Monitor under
``--eval.output_dir`` -> the ``.pt`` checkpoint (a local file, or a key in
``--eval.s3_bucket``) -> metrics file name from the checkpoint path and
dataset name (``donut_eval_ocr``: no checkpoint,
``{task}-{dataset}-metrics.json``) -> one loader per
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
val``, or a ``datasets.load_dataset`` source). One device per process:
``--task.device`` (default ``cuda``; without a card that raises,
``--task.device cpu`` asks for the CPU). Under ``torchrun`` each
``(data, fsdp)`` rank evaluates its own shards of the data; with
``--task.mesh.model N`` the N ranks of a model group hold the model cut
over heads, MLP and vocabulary and evaluate the same shards together.
Rank 0 merges one metric tree per model group (:func:`_merge_metric_trees`)
into the one metrics file::

    torchrun --standalone --nproc_per_node 2 -m pixparse_tpu_torch.app.eval \
        ... --task.mesh.model 2            # add --task.device cpu: gloo

``--eval.s3_bucket B`` reads ``--eval.checkpoint_path`` as a key in bucket
B (each rank downloads it; the metrics file is named after the key); it
needs ``boto3`` and S3 credentials (``ModuleNotFoundError`` without
``boto3``).
``donut_eval_ocr``, the HF Donut baseline, takes ``--task.model_name`` as a
local model directory (or a name in the HF cache) and needs
``transformers``.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field, replace
from typing import List

from pixparse_tpu_torch.data import DataCfg, create_loader
from pixparse_tpu_torch.data.wds import create_image_text_pipe
from pixparse_tpu_torch.framework import Monitor, evaluate, random_seed, setup_logging
from pixparse_tpu_torch.framework.cli import ConfigArgumentParser, peek_flag
from pixparse_tpu_torch.framework.task import TaskEval
from pixparse_tpu_torch.models.interop import load_torch_checkpoint, normalize_state_dict
from pixparse_tpu_torch.parallel.mesh import MeshEnv
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
from pixparse_tpu_torch.utils.s3_utils import load_checkpoint_from_s3

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


_SUM_KEY_HINTS = ("samples", "count", "num", "correct", "total")


def _merge_metric_trees(trees, key: str = ""):
    """Merge per-host metric trees (hosts evaluate disjoint data shards):
    count-like leaves (name contains samples/count/num/correct/total) are
    SUMMED, other numeric leaves averaged. The average is unweighted across
    hosts, as in the JAX package: with uneven shard sizes a ratio metric
    carries a small bias; tasks exposing counts merge exactly."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    if isinstance(first, dict):
        return {
            k: _merge_metric_trees([t[k] for t in trees if k in t], k)
            for k in first
        }
    if isinstance(first, (int, float)):
        vals = [t for t in trees if isinstance(t, (int, float))]
        if any(h in key.lower() for h in _SUM_KEY_HINTS):
            return sum(vals)
        return sum(vals) / max(1, len(vals))
    return first


def eval(cfg: "EvalCfg", task, eval_loaders: dict):
    """``evaluate`` on this rank's data; with more than one rank the trees
    of model rank 0 (one per model group: its ranks saw the same pages)
    are gathered and merged, and rank 0 writes the one metrics file."""
    metrics = evaluate(task, eval_loaders)
    device_env = task.device_env
    if device_env.process_count > 1:
        trees = device_env.all_gather_object((device_env.model_rank, metrics))
        metrics = _merge_metric_trees([tree for model_rank, tree in trees if model_rank == 0])
    if device_env.is_primary():
        with open(cfg.metrics_file_path, "w") as fh:
            json.dump(metrics, fh)
    return metrics


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

    # first: joins the process group under torchrun; raises when CUDA is
    # asked for (the default) and there is none
    mesh_cfg = args.task.mesh
    device_env = MeshEnv.initialize(
        data=mesh_cfg.data, fsdp=mesh_cfg.fsdp, model=mesh_cfg.model, device=args.task.device)
    try:
        return _main(eval_cfg, args.task, data_cfg, device_env)
    finally:
        device_env.close()


def _main(eval_cfg: EvalCfg, task_args, data_cfg: DataCfg, device_env: MeshEnv) -> int:
    task, task_cfg = TaskFactory.create_task(
        task_name=eval_cfg.task_name, task_args=task_args, device_env=device_env, monitor=None,
    )
    random_seed(eval_cfg.seed, rank=device_env.data_rank)  # alike in a model group
    _logger.info(f"Device env is {device_env}")

    os.makedirs(eval_cfg.output_dir, exist_ok=True)
    if device_env.is_primary():
        setup_logging(os.path.join(eval_cfg.output_dir, eval_cfg.log_filename))
    task.monitor = Monitor(
        eval_cfg.experiment, output_dir=eval_cfg.output_dir,
        output_enabled=device_env.is_primary(),
    )

    if eval_cfg.task_name == "donut_eval_ocr":  # the HF model brings its weights
        file_name = f"{eval_cfg.task_name}-{eval_cfg.dataset_name}-metrics.json"
    else:
        if eval_cfg.s3_bucket != "":  # every rank downloads
            _logger.info("s3 bucket specified. Loading checkpoint from s3.")
            task.resume_state_dict = normalize_state_dict(
                load_checkpoint_from_s3(eval_cfg.s3_bucket, eval_cfg.checkpoint_path))
        else:
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
            world_size=device_env.data_size,  # a model group reads the same shards
            global_rank=device_env.data_rank,
            create_decoder_pipe=create_image_text_pipe,
        )
        # one loader per dataset identifier; the task keeps those it evaluates
        for name in (eval_cfg.datasets or ["eval"])
    }

    task.setup()
    metrics = eval(eval_cfg, task, loaders)
    _logger.info("eval metrics: %s", metrics)
    task.end()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
