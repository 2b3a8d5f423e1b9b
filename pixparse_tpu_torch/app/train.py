"""Train CLI: ``python -m pixparse_tpu_torch.app.train`` (counterpart of
:mod:`pixparse_tpu.app.train`).

The same three-scope flag surface (``--train.* --task.* --data.*`` with dash
variants and ``--config_path``) and the same flow: device -> TaskFactory ->
seeded RNG -> auto-named experiment -> refuse to clobber an existing
experiment log -> Monitor -> optional resume -> loader with the task's
collate and preprocessing -> ``train_setup`` -> interval loop.

Per interval the app writes BOTH the reference-compatible model-only
``checkpoint-{i}.pt`` AND the full train state (parameters, optimizer state,
counters) as the directory ``checkpoint-{i}/``; ``--train.resume`` with such
a directory (or with no path: the newest one of the experiment) restores
optimizer and interval state too, with a ``.pt`` file only the weights.

Tasks: ``cruller_pretrain`` and the finetunes ``cruller_finetune_{cord,
docvqa,rvlcdip,xent}``. Data: ``--data.train.format webdataset`` (tar
shards) or ``hf_dataset`` (``--data.train.source SinglePageDocVQA`` reads
``$PIXPARSE_DOCVQA_DIR``; any other source goes to
``datasets.load_dataset(source)[split]``), batched with the task's collate.
A ``.pt`` from another task (a pretrain checkpoint into a finetune) loads
with the vocabulary resized to the task's; ``cruller_finetune_xent`` takes
the encoder of a Cruller checkpoint and writes ``encoder.trunk.*`` +
``final_fc.*``::

    python -m pixparse_tpu_torch.app.train \\
        --train.task_name cruller_finetune_cord \\
        --train.resume true --train.checkpoint_path ./pretrain/checkpoint-29.pt \\
        --task.model_name cruller_base --task.dtype bfloat16 \\
        --data.train.format hf_dataset --data.train.source naver-clova-ix/cord-v2 \\
        --data.train.split train --data.train.num_samples 800 --data.train.batch_size 8

The task runs on ``--task.device`` (default ``cuda``; without a card that
raises, ``--task.device cpu`` asks for the CPU), one device per process.
Under ``torchrun`` the processes form a mesh (``--task.mesh.data/fsdp/model``,
:mod:`pixparse_tpu_torch.parallel.mesh`): NCCL on the cards, gloo on the
CPU; the train state is FSDP2-sharded over ``(data, fsdp)`` and, with
``--task.mesh.model > 1``, split over ``model`` first (tensor parallelism:
heads, MLP and vocabulary, :mod:`pixparse_tpu_torch.parallel.tensor_parallel`);
each ``(data, fsdp)`` rank reads its own shards of the data (the ranks of a
model group read the same), rank 0 names the experiment and alone writes
logs, summaries and the ``.pt``, and every rank takes part in each
checkpoint save::

    torchrun --standalone --nproc_per_node 2 -m pixparse_tpu_torch.app.train \
        ... --task.device cpu --task.mesh.fsdp 2
    torchrun --standalone --nproc_per_node 2 -m pixparse_tpu_torch.app.train \
        ... --task.device cpu --task.mesh.model 2

The S3 resume branch raises.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from datetime import datetime
from typing import Dict, Optional

from pixparse_tpu_torch.data import DataCfg, create_loader
from pixparse_tpu_torch.framework import (
    Monitor,
    random_seed,
    setup_logging,
    train_one_interval,
)
from pixparse_tpu_torch.framework.checkpoint import (
    checkpoint_path as native_checkpoint_path,
    latest_checkpoint,
    restore_train_state,
    save_checkpoint,
    wait_for_saves,
)
from pixparse_tpu_torch.framework.cli import ConfigArgumentParser, peek_flag
from pixparse_tpu_torch.framework.task import StopTraining, TaskTrain
from pixparse_tpu_torch.models.interop import load_torch_checkpoint, save_torch_checkpoint
from pixparse_tpu_torch.parallel.mesh import MeshEnv
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
from pixparse_tpu_torch.utils.name_utils import clean_name

_logger = logging.getLogger("train")


@dataclass
class TrainCfg:
    experiment: Optional[str] = None
    output_dir: str = "./output"
    log_filename: str = "out.log"
    s3_bucket: str = ""
    resume: bool = False
    checkpoint_path: str = ""
    output_checkpoint_dir: Optional[str] = None  # default output_dir/checkpoints
    seed: int = 42
    task_name: str = "cruller_pretrain"
    wandb: bool = False
    wandb_project: str = "unknown"
    tensorboard: bool = False
    log_eval_data: bool = False
    profile: bool = False  # torch.profiler trace of the first interval
    profile_dir: str = ""  # default {experiment}/profile


def _save_interval_checkpoints(cfg: TrainCfg, task, interval: int, completed: bool = True):
    """``completed=False`` (a stop mid-interval): the weights snapshot is
    written under this interval's name, but the metadata records the previous
    interval as the last complete one, so a resume re-runs this interval from
    its start instead of skipping its remaining batches. Under a mesh both
    the gather of the ``.pt`` weights and the sharded save are collectives:
    every rank calls this, and rank 0 alone writes the ``.pt``."""
    device_env = task.device_env
    checkpoint_dir = os.path.join(cfg.output_checkpoint_dir, cfg.experiment)
    os.makedirs(checkpoint_dir, exist_ok=True)
    weights = task.state_dict()
    if device_env.is_primary():
        save_torch_checkpoint(os.path.join(checkpoint_dir, f"checkpoint-{interval}.pt"), weights)
    last_complete = interval if completed else interval - 1
    save_checkpoint(
        native_checkpoint_path(checkpoint_dir, interval),
        task.state,
        metadata={"interval": last_complete, "step": int(task.state.step)},
    )


def train(cfg: TrainCfg, task, loaders: Dict[str, object]):
    # graceful stop: SIGTERM/SIGINT checkpoints at the next step boundary
    # before exiting
    import signal

    stopped = {"flag": False}

    def _request_stop(signum, frame):
        _logger.warning("signal %s received: checkpointing then exiting", signum)
        stopped["flag"] = True
        task._stop_requested = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread (tests)
            pass

    train_loader = loaders["train"]
    try:
        for i in range(task.start_interval, task.num_intervals):
            train_loader.set_interval(i)
            task.interval_idx = i
            try:
                if cfg.profile and i == task.start_interval:
                    from pixparse_tpu_torch.framework.profiling import trace

                    logdir = cfg.profile_dir or os.path.join(
                        cfg.output_dir, cfg.experiment, "profile"
                    )
                    with trace(logdir):
                        train_one_interval(task, train_loader)
                else:
                    train_one_interval(task, train_loader)
            except StopTraining:
                # stopped mid-interval: snapshot under interval i with metadata
                # pointing at i-1, so a resume replays interval i in full
                _save_interval_checkpoints(cfg, task, i, completed=False)
                _logger.warning("stopped during interval %d; state saved", i)
                break

            _save_interval_checkpoints(cfg, task, i)
            if stopped["flag"]:
                break
        wait_for_saves()
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    # peek at task_name to build the right --task.* flag set
    task_name = peek_flag(argv, "train.task_name") or TrainCfg.task_name
    train_tasks = sorted(
        n for n, (cls, _) in TASK_CLASS_REGISTRY.items() if issubclass(cls, TaskTrain)
    )
    if task_name not in train_tasks:
        raise SystemExit(f"unknown train task {task_name!r} (known: {train_tasks})")
    _, task_cfg_cls = TASK_CLASS_REGISTRY[task_name]

    parser = ConfigArgumentParser(description="pixparse_tpu_torch train")
    parser.add_arguments(TrainCfg, dest="train")
    parser.add_arguments(task_cfg_cls, dest="task")
    parser.add_arguments(DataCfg, dest="data")
    args = parser.parse_args(argv)
    train_cfg: TrainCfg = args.train
    data_cfg: DataCfg = args.data

    # first: joins the process group under torchrun; raises when CUDA is
    # asked for (the default) and there is none
    mesh_cfg = args.task.mesh
    device_env = MeshEnv.initialize(
        data=mesh_cfg.data, fsdp=mesh_cfg.fsdp, model=mesh_cfg.model, device=args.task.device)
    try:
        return _main(train_cfg, args.task, data_cfg, device_env)
    finally:
        device_env.close()


def _main(train_cfg: TrainCfg, task_args, data_cfg: DataCfg, device_env: MeshEnv) -> int:
    task, task_cfg = TaskFactory.create_task(
        task_name=train_cfg.task_name, task_args=task_args, device_env=device_env, monitor=None,
    )
    # the ranks of a model group draw and read alike: one stream per data rank
    random_seed(train_cfg.seed, rank=device_env.data_rank)
    _logger.info(f"Device env is {device_env}")

    if train_cfg.experiment is None:
        model_name_safe = clean_name(task_cfg.model_name)
        date_str = datetime.now().strftime("%Y%m%d-%H%M%S")
        date_str = device_env.broadcast_object(date_str)  # one name for every rank
        experiment = "-".join(
            [
                date_str,
                f"task_{train_cfg.task_name}",
                f"model_{model_name_safe}",
                f"lr_{'{:.1e}'.format(task_cfg.opt.learning_rate)}",
                f"b_{data_cfg.train.batch_size}",
            ]
        )
        train_cfg = replace(train_cfg, experiment=experiment)

    experiment_path = os.path.join(train_cfg.output_dir, train_cfg.experiment)
    log_path = None
    should_abort = False
    if device_env.is_primary():
        os.makedirs(experiment_path, exist_ok=True)
        log_path = os.path.join(experiment_path, train_cfg.log_filename)
        should_abort = os.path.exists(log_path) and not train_cfg.resume
    # every rank takes the same branch, or the others wait in collectives
    if device_env.broadcast_object(should_abort):
        _logger.error(
            "Error. Experiment already exists. Use --train.experiment to "
            "specify a new experiment."
        )
        return -1

    setup_logging(log_path)
    task.monitor = Monitor(
        train_cfg.experiment,
        output_dir=experiment_path,
        wandb=train_cfg.wandb,
        wandb_project=train_cfg.wandb_project,
        tensorboard=train_cfg.tensorboard,
        output_enabled=device_env.is_primary(),
        log_eval_data=train_cfg.log_eval_data,
    )

    native_resume_dir = None
    if train_cfg.resume:
        checkpoint_path = train_cfg.checkpoint_path
        if not checkpoint_path:
            # resume-latest: the newest full-state dir of this experiment
            default_ckpt_dir = train_cfg.output_checkpoint_dir or os.path.join(
                experiment_path, "checkpoints"
            )
            checkpoint_path = (
                latest_checkpoint(os.path.join(default_ckpt_dir, train_cfg.experiment)) or ""
            )
            if checkpoint_path:
                _logger.info("resume: found latest checkpoint %s", checkpoint_path)
            else:
                _logger.info("resume requested but no checkpoint found; fresh start")
        if not checkpoint_path:
            pass
        elif train_cfg.s3_bucket != "":
            raise NotImplementedError(
                "--train.s3_bucket: resuming from S3 is not ported (it needs "
                "network access); copy the checkpoint to a local path"
            )
        elif os.path.isdir(checkpoint_path):
            native_resume_dir = checkpoint_path  # restored after train_setup
        else:
            assert os.path.isfile(
                checkpoint_path
            ), f"Cannot find checkpoint {checkpoint_path}: File not found"
            task.resume_state_dict = load_torch_checkpoint(checkpoint_path)

    output_checkpoint_dir = train_cfg.output_checkpoint_dir or os.path.join(
        experiment_path, "checkpoints"
    )
    os.makedirs(output_checkpoint_dir, exist_ok=True)
    train_cfg = replace(train_cfg, output_checkpoint_dir=output_checkpoint_dir)
    _logger.info(task_cfg)
    _logger.info(train_cfg)

    assert data_cfg.train is not None, "the train app requires --data.train.*"
    loaders = {
        "train": create_loader(
            data_cfg.train,
            is_train=True,
            collate_fn=task.collate_fn,
            image_preprocess=getattr(task, "image_preprocess_train", None),
            anno_preprocess=getattr(task, "anno_preprocess_train", None),
            image_fmt=task_cfg.model.image_encoder.image_fmt,
            seed=train_cfg.seed,
            world_size=device_env.data_size,
            global_rank=device_env.data_rank,
        )
    }
    task.train_setup(num_batches_per_interval=loaders["train"].num_batches, seed=train_cfg.seed)

    if native_resume_dir is not None:
        task.state, meta = restore_train_state(native_resume_dir, task.state)
        task.start_interval = int(meta.get("interval", -1)) + 1
        task.step_idx = int(task.state.step)
        _logger.info(
            "restored full train state from %s (interval %s, step %s)",
            native_resume_dir, task.start_interval - 1, task.step_idx,
        )

    train(train_cfg, task, loaders)
    task.monitor.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
