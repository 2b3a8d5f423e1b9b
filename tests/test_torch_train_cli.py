"""End-to-end run of the port's train CLI on the CPU (``--task.device cpu``):
a synthetic webdataset shard (the one ``tests/test_app_e2e.py`` makes) ->
``pixparse_tpu_torch.app.train`` runs intervals, writes the model-only
``.pt`` and the full-state directory per interval -> refuses to clobber ->
resumes from a full-state directory -> the ``.pt`` loads into the JAX package
and gives the port's logits (atol 1e-4, fp32, the model-parity bound of
``tests/test_torch_models.py``). A resume from ``--train.s3_bucket``, through
a stand-in ``boto3`` that serves local files, loads the weights the local
``.pt`` resume loads, bit for bit; without ``boto3`` it raises.
"""

import io
import json
import os
import shutil
import sys
import tarfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.models.torch_interop import cruller_params_from_torch
from pixparse_tpu.models.torch_interop import load_torch_checkpoint as jax_load_torch_checkpoint
from pixparse_tpu_torch.app import train as app_train
from pixparse_tpu_torch.app.train import TrainCfg, main as train_main, train
from pixparse_tpu_torch.data import DatasetCfg, create_loader
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.framework.checkpoint import latest_checkpoint, restore_train_state
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.models.cruller import Cruller
from pixparse_tpu_torch.models.interop import load_cruller_state_dict, load_torch_checkpoint
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import TokenizerCfg
from test_torch_eval_cli import s3_stand_in


def _make_shard(path: str, n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = Image.fromarray(rng.randint(0, 255, (80, 60), np.uint8), "L")
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"{i:05d}.png")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            anno = json.dumps(
                {"pages": [{"text": [f"hello world {i}", "the quick brown fox"]}]}
            ).encode()
            info = tarfile.TarInfo(f"{i:05d}.json")
            info.size = len(anno)
            tf.addfile(info, io.BytesIO(anno))


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wds") / "shard-00000.tar")
    _make_shard(path, 32)
    return path


def _train_args(shard, out_dir, experiment="e2e", extra=(), device="cpu"):
    args = [
        "--train.task_name", "cruller_pretrain",
        "--train.experiment", experiment,
        "--train.output_dir", out_dir,
        "--train.seed", "42",
        "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel",
        "--task.num_intervals", "2",
        "--task.num_warmup_intervals", "1",
        "--task.opt.learning_rate", "1e-4",
        "--task.dtype", "float32",
        "--data.train.source", shard,
        "--data.train.num_samples", "16",
        "--data.train.batch_size", "8",
        "--data.train.split", "train",
        "--data.train.num_workers", "2",
        *extra,
    ]
    if device:
        args += ["--task.device", device]
    return args


@pytest.fixture(scope="module")
def run(shard, tmp_path_factory):
    """One two-interval run of the CLI, shared by the tests below."""
    out_dir = str(tmp_path_factory.mktemp("output"))
    rc = train_main(_train_args(shard, out_dir))
    exp = os.path.join(out_dir, "e2e")
    return rc, out_dir, exp, os.path.join(exp, "checkpoints", "e2e")


def test_train_cli_writes_both_checkpoints_per_interval(run):
    rc, _, exp, ckpt_dir = run
    assert rc == 0
    for i in (0, 1):
        assert os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{i}.pt"))
        assert os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{i}", "state.pt"))
        with open(os.path.join(ckpt_dir, f"checkpoint-{i}", "metadata.json")) as fh:
            assert json.load(fh) == {"interval": i, "step": 2 * (i + 1)}
    assert os.path.isfile(os.path.join(exp, "out.log"))
    assert os.path.isfile(os.path.join(exp, "summary.csv"))
    assert latest_checkpoint(ckpt_dir) == os.path.join(ckpt_dir, "checkpoint-1")


def test_second_run_refuses_to_clobber(run, shard):
    _, out_dir, _, _ = run
    assert train_main(_train_args(shard, out_dir)) == -1


def test_resume_from_full_state_dir_starts_at_the_next_interval(run, shard, tmp_path):
    _, _, _, ckpt_dir = run
    resume_out = str(tmp_path / "resume_out")
    rc = train_main(_train_args(
        shard, resume_out, experiment="e2e_resume",
        extra=["--train.resume", "true",
               "--train.checkpoint_path", os.path.join(ckpt_dir, "checkpoint-0")],
    ))
    assert rc == 0
    resumed = os.listdir(os.path.join(resume_out, "e2e_resume", "checkpoints", "e2e_resume"))
    # started from interval 1: only checkpoint-1 is written
    assert "checkpoint-1.pt" in resumed and "checkpoint-1" in resumed
    assert "checkpoint-0.pt" not in resumed and "checkpoint-0" not in resumed
    # the optimizer state and the step counter came along: two more updates
    # on top of interval 0's two
    saved = torch.load(
        os.path.join(resume_out, "e2e_resume", "checkpoints", "e2e_resume", "checkpoint-1",
                     "state.pt"), weights_only=True)
    assert saved["step"] == 4 and int(saved["opt_state"]["count"]) == 4
    first = torch.load(os.path.join(ckpt_dir, "checkpoint-0", "state.pt"), weights_only=True)
    assert saved["seed"] == first["seed"]
    assert set(saved["params"]) == set(first["params"])


def test_resume_from_pt_loads_weights_only(run, shard, tmp_path):
    _, _, _, ckpt_dir = run
    out = str(tmp_path / "pt_out")
    rc = train_main(_train_args(
        shard, out, experiment="from_pt",
        extra=["--train.resume", "true", "--task.num_intervals", "1",
               "--train.checkpoint_path", os.path.join(ckpt_dir, "checkpoint-1.pt")],
    ))
    assert rc == 0
    assert os.listdir(os.path.join(out, "from_pt", "checkpoints", "from_pt")) != []


def test_resume_from_s3_loads_the_weights_of_the_local_pt(run, shard, tmp_path, monkeypatch):
    """``--train.s3_bucket b --train.checkpoint_path checkpoint-1.pt``: the
    path is a key in the bucket. The parameters after ``train_setup`` equal
    the local ``.pt`` resume's bit for bit, and the run trains on."""
    _, _, _, ckpt_dir = run
    boto3 = s3_stand_in(tmp_path / "s3")
    (tmp_path / "s3" / "b").mkdir(parents=True)
    shutil.copy(os.path.join(ckpt_dir, "checkpoint-1.pt"), tmp_path / "s3" / "b" / "checkpoint-1.pt")
    monkeypatch.setitem(sys.modules, "boto3", boto3)
    params = {}

    def recorded(orig):
        def started(cfg, task, loaders):
            params[cfg.experiment] = {k: v.detach().clone() for k, v in task.state.params.items()}
            return orig(cfg, task, loaders)
        return started

    monkeypatch.setattr(app_train, "train", recorded(app_train.train))
    for experiment, path, extra in (
            ("local", os.path.join(ckpt_dir, "checkpoint-1.pt"), []),
            ("s3", "checkpoint-1.pt", ["--train.s3_bucket", "b"])):
        assert train_main(_train_args(shard, str(tmp_path / "out"), experiment=experiment, extra=[
            "--train.resume", "true", "--task.num_intervals", "1",
            "--train.checkpoint_path", path, *extra])) == 0
    assert boto3.calls == [("b", "checkpoint-1.pt")]
    assert os.path.isfile(tmp_path / "out" / "s3" / "checkpoints" / "s3" / "checkpoint-0.pt")
    local, s3 = params["local"], params["s3"]
    assert set(s3) == set(local) and len(local) > 0
    for k, v in local.items():
        assert torch.equal(s3[k], v), k


def test_s3_resume_without_boto3_raises(shard, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)  # not installed
    with pytest.raises(ModuleNotFoundError, match="boto3"):
        train_main(_train_args(shard, str(tmp_path / "o"), extra=[
            "--train.resume", "true", "--train.s3_bucket", "b",
            "--train.checkpoint_path", "checkpoint-1.pt"]))


def test_port_checkpoint_loads_into_the_jax_package(run):
    _, _, _, ckpt_dir = run
    path = os.path.join(ckpt_dir, "checkpoint-1.pt")
    vocab = 262  # byte-level tokenizer + the two pretrain tokens
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=vocab)
    params = cruller_params_from_torch(jax_load_torch_checkpoint(path), jv, jb)
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 48, 1).astype(np.float32)
    txt = rng.randint(4, vocab, (2, 12)).astype(np.int64)
    want = np.asarray(JaxCruller(jv, jb).apply(
        {"params": params}, jnp.asarray(img), jnp.asarray(txt, jnp.int32)))
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs

    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=vocab)
    model = Cruller(v, b).eval()
    load_cruller_state_dict(model, load_torch_checkpoint(path))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(txt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_train_cli_without_a_card_raises_unless_cpu_is_asked_for(shard, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(_train_args(shard, str(tmp_path / "o"), device=None))
    with pytest.raises(ValueError, match="unknown remat mode"):
        train_main(_train_args(shard, str(tmp_path / "o2"), extra=["--task.remat", "sometimes"]))
    with pytest.raises(SystemExit):
        train_main(["--train.task_name", "cruller_eval_ocr"])


def test_stop_request_mid_interval_saves_and_resume_replays_the_interval(shard, tmp_path):
    env = DeviceEnv.initialize("cpu")
    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        opt=OptimizationCfg(learning_rate=1e-4), num_intervals=2, num_warmup_intervals=0,
        dtype="float32", device="cpu",
    )
    task = TaskCrullerPretrain(cfg, env)
    loader = create_loader(
        DatasetCfg(source=shard, num_samples=16, batch_size=8, split="train", num_workers=1),
        is_train=True, collate_fn=task.collate_fn,
        image_preprocess=task.image_preprocess_train, anno_preprocess=task.anno_preprocess_train,
        seed=0,
    )
    task.train_setup(num_batches_per_interval=loader.num_batches, seed=0)
    steps = {"n": 0}
    inner = task.train_step_fn

    def stop_after_first(state, batch):
        steps["n"] += 1
        task._stop_requested = True  # what the signal handler sets
        return inner(state, batch)

    task.train_step_fn = stop_after_first
    tcfg = TrainCfg(experiment="stop", output_dir=str(tmp_path),
                    output_checkpoint_dir=str(tmp_path / "ckpt"))
    train(tcfg, task, {"train": loader})
    assert steps["n"] == 1
    ckpt = str(tmp_path / "ckpt" / "stop" / "checkpoint-0")
    assert os.path.isfile(str(tmp_path / "ckpt" / "stop" / "checkpoint-0.pt"))
    fresh = TaskCrullerPretrain(cfg, env)
    fresh.train_setup(num_batches_per_interval=loader.num_batches, seed=1)
    state, meta = restore_train_state(ckpt, fresh.state)
    assert meta == {"interval": -1, "step": 1}  # interval 0 is replayed in full
    assert state.step == 1 and int(state.opt_state["count"]) == 1
    for k, v in task.state.params.items():
        assert torch.equal(v.detach(), fresh.model.state_dict()[k]), k
