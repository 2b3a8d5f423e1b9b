"""The port's train and eval CLIs over the finetune and eval tasks, on the
CPU (``--task.device cpu``, ``cruller_test``, fp32):

- ``app.train --train.task_name cruller_finetune_docvqa --data.train.format
  hf_dataset --data.train.source SinglePageDocVQA`` over a tmp directory of
  PNGs written here (``PIXPARSE_DOCVQA_DIR``), then ``app.eval
  --eval.task_name cruller_eval_docvqa`` on its checkpoint: the metrics file
  holds ANLS, equal to what the JAX package's ``app.eval`` writes for the
  same checkpoint and data;
- a CORD finetune run resumed from a pretrain ``.pt`` (the vocabulary grows
  from 262 to 317 entries through the CLI) over a local image folder read by
  ``datasets.load_dataset`` (offline): at learning rate 0 its checkpoint
  holds the pretrain rows and the resize replay's new rows;
- both entry points list the new tasks by kind, and raise without
  ``--task.device cpu`` when no card is present.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pixparse_tpu.app.eval import main as jax_eval_main
from pixparse_tpu_torch.app.eval import main as eval_main
from pixparse_tpu_torch.app.train import main as train_main
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.models.interop import DEC_PREFIX, resize_token_embeddings
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.tokenizers import TokenizerCfg

COMMON = ["--task.model_name", "cruller_test", "--task.tokenizer.name", "pixparse_bytelevel",
          "--task.dtype", "float32"]


def _png(path, seed):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, (80, 60), np.uint8), "L").save(path)


@pytest.fixture(scope="module")
def docvqa_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("docvqa")
    for split in ("train", "val"):
        (root / split / "documents").mkdir(parents=True)
        entries = []
        for i in range(4):
            _png(root / split / "documents" / f"{i}.png", i + (10 if split == "val" else 0))
            entries.append({"image": f"documents/{i}.png", "question": f"what is field {i}?",
                            "answers": [f"value {i}"], "questionId": 100 + i})
        (root / split / f"{split}_v1.0.json").write_text(json.dumps({"data": entries}))
    return str(root)


def _train_flags(task, out_dir, source, extra=()):
    return ["--train.task_name", task, "--train.experiment", "e", "--train.output_dir", out_dir,
            *COMMON, "--task.num_intervals", "1", "--task.num_warmup_intervals", "0",
            "--data.train.format", "hf_dataset", "--data.train.source", source,
            "--data.train.num_samples", "4", "--data.train.batch_size", "2",
            "--data.train.split", "train", "--data.train.num_workers", "1", *extra]


def _eval_flags(ckpt, out_dir):
    return ["--eval.task_name", "cruller_eval_docvqa", "--eval.checkpoint_path", ckpt,
            "--eval.dataset_name", "DocVQA", "--eval.output_dir", out_dir, *COMMON,
            "--data.eval.format", "hf_dataset", "--data.eval.source", "SinglePageDocVQA",
            "--data.eval.num_samples", "4", "--data.eval.batch_size", "2",
            "--data.eval.split", "val", "--data.eval.num_workers", "1"]


def _metrics(out_dir):
    [name] = [f for f in os.listdir(out_dir) if f.endswith("-metrics.json")]
    with open(os.path.join(out_dir, name)) as fh:
        return json.load(fh)


def test_docvqa_finetune_then_eval_through_the_clis(docvqa_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PIXPARSE_DOCVQA_DIR", docvqa_dir)
    out = str(tmp_path / "train")
    flags = _train_flags("cruller_finetune_docvqa", out, "SinglePageDocVQA",
                         ["--task.opt.learning_rate", "1e-3", "--task.device", "cpu"])
    assert train_main(flags) == 0
    ckpt = os.path.join(out, "e", "checkpoints", "e", "checkpoint-0.pt")
    sd = torch.load(ckpt, weights_only=True)
    assert sd[DEC_PREFIX + "embed_tokens.weight"].shape[0] == 262 + 5  # the DocVQA tags
    with open(os.path.join(out, "e", "checkpoints", "e", "checkpoint-0", "metadata.json")) as fh:
        assert json.load(fh) == {"interval": 0, "step": 2}
    assert eval_main(_eval_flags(ckpt, str(tmp_path / "eval")) + ["--task.device", "cpu"]) == 0
    got = _metrics(str(tmp_path / "eval"))
    assert set(got) == {"eval"} and set(got["eval"]["average"]) == {"ANLS"}
    assert jax_eval_main(_eval_flags(ckpt, str(tmp_path / "jax_eval"))) == 0
    assert got == _metrics(str(tmp_path / "jax_eval"))


@pytest.fixture
def cord_folder(tmp_path, monkeypatch):
    """An image folder with ``metadata.jsonl`` (``file_name``,
    ``ground_truth``), as ``datasets.load_dataset(<dir>)`` reads it; the
    datasets cache inside tmp, nothing fetched."""
    import datasets.config

    cache = tmp_path / "hf_cache"
    for k, v in (("HF_DATASETS_OFFLINE", "1"), ("HF_HUB_OFFLINE", "1"),
                 ("HF_DATASETS_CACHE", str(cache))):
        monkeypatch.setenv(k, v)
    # the package reads these at import: an earlier import in this process
    # would keep its own
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", cache)
    root = tmp_path / "cord"
    (root / "train").mkdir(parents=True)
    with open(root / "train" / "metadata.jsonl", "w") as fh:
        for i in range(4):
            _png(root / "train" / f"{i}.png", i)
            gt = {"gt_parse": {"menu": {"nm": f"item {i}", "price": f"{i}.00"},
                               "total": {"total_price": f"{i}.00"}}}
            fh.write(json.dumps({"file_name": f"{i}.png", "ground_truth": json.dumps(gt)}) + "\n")
    return str(root)


def test_cord_finetune_resumes_from_a_pretrain_checkpoint(cord_folder, tmp_path):
    pre = TaskCrullerPretrain(TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        device="cpu"), DeviceEnv.initialize("cpu"))
    pre.train_setup(num_batches_per_interval=1, seed=5)
    pre_sd = pre.state_dict()
    pre_path = str(tmp_path / "pretrain.pt")
    torch.save(pre_sd, pre_path)
    out = str(tmp_path / "train")
    flags = _train_flags("cruller_finetune_cord", out, cord_folder, [
        "--task.opt.learning_rate", "0", "--task.opt.weight_decay", "0", "--task.device", "cpu",
        "--train.resume", "true", "--train.checkpoint_path", pre_path])
    assert train_main(flags) == 0
    got = torch.load(os.path.join(out, "e", "checkpoints", "e", "checkpoint-0.pt"),
                     weights_only=True)
    key = DEC_PREFIX + "embed_tokens.weight"
    assert pre_sd[key].shape[0] == 262 and got[key].shape[0] == 317
    want = resize_token_embeddings(pre_sd, 317)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert set(got) == set(want)


@pytest.mark.parametrize("app", ["train", "eval"])
def test_entry_points_list_the_tasks_by_kind(app):
    main = train_main if app == "train" else eval_main
    other = "cruller_eval_cord" if app == "train" else "cruller_finetune_cord"
    with pytest.raises(SystemExit) as err:
        main([f"--{app}.task_name", other])
    listed = str(err.value).rsplit("[", 1)[1]  # the list of known tasks
    names = (["cruller_finetune_cord", "cruller_finetune_docvqa", "cruller_finetune_rvlcdip",
              "cruller_finetune_xent", "cruller_pretrain"] if app == "train" else
             ["cruller_eval_cord", "cruller_eval_docvqa", "cruller_eval_ocr", "cruller_eval_rvlcdip"])
    assert all(n in listed for n in names) and other not in listed


@pytest.mark.parametrize("task", ["cruller_finetune_cord", "cruller_finetune_docvqa",
                                  "cruller_finetune_rvlcdip", "cruller_finetune_xent",
                                  "cruller_eval_cord", "cruller_eval_docvqa", "cruller_eval_rvlcdip"])
def test_entry_points_raise_without_a_card(task, tmp_path, monkeypatch, docvqa_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PIXPARSE_DOCVQA_DIR", docvqa_dir)
    if "finetune" in task:
        call = lambda: train_main(_train_flags(task, str(tmp_path), "SinglePageDocVQA"))
    else:
        flags = _eval_flags(str(tmp_path / "missing.pt"), str(tmp_path))
        call = lambda: eval_main([task if f == "cruller_eval_docvqa" else f for f in flags])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_chip_smoke_finetune_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``finetune_tasks`` phase, run on the CPU at
    cruller_test (batches of 2 to 4, a 300-entry tokenizer): its own checks
    pass (falling finite losses, the kernel path's step-1 loss and gradients
    against the plain path's, finite metrics, the first DocVQA decode step
    on ragged prompts against a plain parallel pass) and it records every
    run."""
    import importlib.util
    import tempfile
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    counts = cs.phase_finetune_tasks(
        torch, model_name="cruller_test", B=2, n_batches=2,
        eval_batch={"cord": 2, "docvqa": 3, "rvlcdip": 4}, xent=(2, 2), tok_vocab=300, lr=2e-3,
        device="cpu")
    assert set(counts) == {f"finetune_tasks_{t}" for t in cs.FINETUNE_TASK_KERNELS}
    assert not any(n for run in counts.values() for n in run.values())  # no kernel on the CPU
    rec = json.loads((tmp_path / "out" / "phases.jsonl").read_text().splitlines()[-1])
    runs = rec["runs"]
    assert runs["finetune_cord"]["vocab"] == [302, 357]
    step1 = runs["finetune_cord"]["step1_kernel_vs_plain"]  # on the CPU both paths are plain
    assert step1["ok"] and step1["leaves"] > 0
    loss = step1["loss"]  # fp32 sums
    assert abs(loss["kernel"] - loss["plain"]) <= 1e-4 * abs(loss["plain"])
    assert all(runs[f"eval_{t}"]["decode_steps"] > 0 for t in ("cord", "docvqa", "rvlcdip"))
    assert runs["eval_docvqa"]["first_decode_vs_plain"]["ok"]
    assert set(runs["eval_cord"]["metrics"]) == {"average_accuracy", "f1_score"}
    assert runs["finetune_xent"]["state_dict_keys"] == ["encoder", "final_fc"]


@pytest.mark.parametrize("task", ["cruller_eval_cord", "cruller_eval_docvqa", "cruller_eval_rvlcdip"])
def test_infer_json_tasks_identical_to_jax(task, tmp_path):
    """``app.infer`` with a JSON-completion task writes the JAX package's
    JSONL (``text`` and the parsed ``json``) from a checkpoint that predates
    the task's tokens (its table grown on both sides)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from pixparse_tpu.app.infer import main as jax_infer_main
    from pixparse_tpu.models import Cruller as JaxCruller
    from pixparse_tpu.models import get_model_config as jax_model_config
    from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
    from pixparse_tpu.models.torch_interop import cruller_params_to_torch
    from pixparse_tpu_torch.app.infer import main as infer_main

    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=262)
    init = nn.unbox(JaxCruller(jv, jb).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 1)), jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.RandomState(3)
    scales = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}

    def redraw(path, x):
        std = scales.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    sd = cruller_params_to_torch(jax.tree_util.tree_map_with_path(redraw, init), jv, jb)
    ckpt = str(tmp_path / "model.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, ckpt)
    (tmp_path / "pages").mkdir()
    for i in range(3):
        _png(tmp_path / "pages" / f"{i}.png", i)
    flags = ["--infer.task_name", task, "--infer.images", str(tmp_path / "pages"),
             "--infer.checkpoint_path", ckpt, "--infer.batch_size", "2",
             "--infer.max_new_tokens", "16", *COMMON]
    ref_out, out = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    assert jax_infer_main(flags + ["--infer.output", ref_out]) == 0
    assert infer_main(flags + ["--infer.output", out, "--task.device", "cpu"]) == 0
    got = open(out, encoding="utf-8").read()
    assert len(got.splitlines()) == 3 and all("text" in json.loads(r) for r in got.splitlines())
    assert got == open(ref_out, encoding="utf-8").read()
