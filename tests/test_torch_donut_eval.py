"""The port's ``donut_eval_ocr`` against the JAX package's, on the CPU.

A tiny ``VisionEncoderDecoderModel`` and ``DonutProcessor`` are built
in-process (no network) and injected into both tasks through ``_load_hf``
(the port's on ``--task.device cpu``): on the same samples, in the dict,
tuple and per-sample-dict layouts, the predictions, CER/WER and
``average_metrics`` are equal. Then ``python -m pixparse_tpu_torch.app.eval
--eval.task_name donut_eval_ocr --task.device cpu`` runs over a local tar
of RGB pages with the model saved to a directory (``--task.model_name``),
no checkpoint, and writes ``donut_eval_ocr-{dataset}-metrics.json`` with
the task's own metrics for those pages.
"""

import io
import json
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from pixparse_tpu.parallel.mesh import MeshEnv
from pixparse_tpu.task import TaskDonutEvalOCR as JaxTask
from pixparse_tpu.task import TaskDonutEvalOCRCfg as JaxCfg
from pixparse_tpu.tokenizers import TokenizerCfg, TokenizerHF
from pixparse_tpu_torch.app.eval import main as eval_main
from pixparse_tpu_torch.device import DeviceEnv
from pixparse_tpu_torch.task.task_donut_eval_ocr import TaskDonutEvalOCR, TaskDonutEvalOCRCfg
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY

TEXTS = ["hello world", "quick brown fox", "second line\nof text"]


def _tiny_donut():
    from transformers import (
        BartConfig,
        DonutImageProcessor,
        DonutProcessor,
        ViTConfig,
        VisionEncoderDecoderConfig,
        VisionEncoderDecoderModel,
    )

    tok = TokenizerHF(TokenizerCfg(name="pixparse_bytelevel")).trunk
    enc_cfg = ViTConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=16, num_channels=3,
    )
    dec_cfg = BartConfig(
        vocab_size=len(tok), d_model=32, decoder_layers=1, encoder_layers=1,
        decoder_attention_heads=2, encoder_attention_heads=2,
        decoder_ffn_dim=64, encoder_ffn_dim=64, max_position_embeddings=24,
    )
    cfg = VisionEncoderDecoderConfig.from_encoder_decoder_configs(enc_cfg, dec_cfg)
    torch.manual_seed(0)
    model = VisionEncoderDecoderModel(cfg)
    model.config.decoder_start_token_id = tok.bos_token_id
    model.config.pad_token_id = tok.pad_token_id
    processor = DonutProcessor(
        image_processor=DonutImageProcessor(
            size={"height": 32, "width": 32}, do_align_long_axis=False
        ),
        tokenizer=tok,
    )
    return processor, model


def _pages(n, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (40, 30, 3), np.uint8), "RGB") for _ in range(n)]


@pytest.fixture(scope="module")
def tasks():
    processor, model = _tiny_donut()
    hook = staticmethod(lambda name: (processor, model))
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTask, "_load_hf", hook)
    mp.setattr(TaskDonutEvalOCR, "_load_hf", hook)
    jtask = JaxTask(JaxCfg(), MeshEnv.initialize(), None)
    ttask = TaskDonutEvalOCR(TaskDonutEvalOCRCfg(device="cpu"), DeviceEnv.initialize("cpu"))
    yield jtask, ttask
    mp.undo()


def test_registered_and_the_raw_text_reference(tasks):
    _, ttask = tasks
    assert TASK_CLASS_REGISTRY["donut_eval_ocr"] == (TaskDonutEvalOCR, TaskDonutEvalOCRCfg)
    anno = {"pages": [{"text": ["hello world", "second line"]}]}
    assert ttask.anno_preprocess_eval(anno) == {
        "text": ["hello world\nsecond line"], "target": ["hello world\nsecond line"]}
    assert ttask.model.device.type == "cpu"


def test_predictions_and_metrics_equal_to_jax(tasks, monkeypatch):
    jtask, ttask = tasks
    pages = _pages(3)
    seen = {}
    for name, task in (("jax", jtask), ("port", ttask)):
        predictions = []
        import pixparse_tpu.task.task_donut_eval_ocr as jmod
        import pixparse_tpu_torch.task.task_donut_eval_ocr as tmod

        mod = jmod if name == "jax" else tmod
        real = mod.ocr_metrics_from_text

        def spy(preds, refs, real=real, predictions=predictions):
            predictions.append(list(preds))
            return real(preds, refs)

        monkeypatch.setattr(mod, "ocr_metrics_from_text", spy)
        metrics = {
            0: task.step({"image": pages, "text": TEXTS}),
            1: task.step((pages[:1], TEXTS[:1])),
            2: task.step([{"image": p, "text": t} for p, t in zip(pages[1:], TEXTS[1:])]),
        }
        seen[name] = (predictions, metrics, task.average_metrics(metrics))
    assert seen["port"] == seen["jax"]
    predictions, metrics, avg = seen["port"]
    assert len(predictions[0]) == 3 and any(predictions[0])
    assert {"cer", "wer"} <= set(metrics[0]) and metrics[0]["cer"] > 0  # a random model can't read
    assert set(avg) == {"cer", "wer"} and np.isfinite(list(avg.values())).all()


def _shard(path, pages):
    with tarfile.open(path, "w") as tf:
        for i, (img, text) in enumerate(zip(pages, TEXTS)):
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            anno = json.dumps({"pages": [{"text": text.split("\n")}]}).encode()
            for name, data in ((f"{i:05d}.png", buf.getvalue()), (f"{i:05d}.json", anno)):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_eval_cli_without_a_checkpoint(tmp_path):
    processor, model = _tiny_donut()
    model_dir = tmp_path / "donut"
    model.save_pretrained(model_dir)
    processor.save_pretrained(model_dir)
    pages = _pages(3, seed=1)
    _shard(tmp_path / "pages.tar", pages)
    out = tmp_path / "out"
    rc = eval_main([
        "--eval.task_name", "donut_eval_ocr", "--eval.dataset_name", "pages",
        "--eval.output_dir", str(out), "--task.model_name", str(model_dir),
        "--task.device", "cpu", "--data.eval.source", str(tmp_path / "pages.tar"),
        "--data.eval.num_samples", "3", "--data.eval.batch_size", "2",
        "--data.eval.split", "eval", "--data.eval.num_workers", "1",
    ])
    assert rc == 0
    got = json.loads((out / "donut_eval_ocr-pages-metrics.json").read_text())
    # the same model and pages straight through the task: the loader's
    # RGB-decoded arrays, batches of 2 then 1
    task = TaskDonutEvalOCR(TaskDonutEvalOCRCfg(model_name=str(model_dir), device="cpu"),
                            DeviceEnv.initialize("cpu"))
    arrays = [np.asarray(p) for p in pages]
    want = task.average_metrics({0: task.step((arrays[:2], TEXTS[:2])),
                                 1: task.step((arrays[2:], TEXTS[2:]))})
    assert got == {"eval": {"average": want}}
    assert set(want) == {"cer", "wer"}
