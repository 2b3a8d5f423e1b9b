"""Package-level contracts of the PyTorch/CUDA port (``pixparse_tpu_torch``).

- importing every module of the port (the list below names them, so a module
  that goes missing is noticed) loads no JAX, flax,
  optax, orbax or ``pixparse_tpu``, and no PIL, transformers, tokenizers,
  wandb, tensorboard, safetensors, timm, datasets, cv2 or boto3 either (those are
  imported inside the functions that need them);
- no source file of the port, nor ``chip_smoke.py``, imports the former
  anywhere or the latter at module level;
- entry points default to the CUDA device and raise without it;
- the kernel wrappers route CPU tensors to their plain versions (the CUDA
  kernels themselves are held against those only on the card, by
  chip_smoke.py and the ``cuda``-marked tests);
- the probe tools' ``main`` runs on the card and raises without it, and
  importing them runs nothing (the JAX package's mxu probe runs at import);
- every source the port's builders compile (``ops/_build.py``'s CUDA
  sources and the headers they include, ``native``'s C++ source) lies
  inside the package and is shipped by its package-data globs.
"""

import ast
import fnmatch
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pixparse_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pixparse_tpu")
LAZY = ("PIL", "transformers", "tokenizers", "wandb", "tensorboard", "safetensors", "timm",
        "datasets", "cv2", "boto3")
MODULES = (
    # serving
    "app.infer", "data.transforms", "device", "framework.cli", "framework.config",
    "framework.logger", "framework.random", "framework.task", "models.bart", "models.config",
    "models.cruller", "models.interop", "models.vit", "ops._build", "ops.attention",
    "ops.decode_attention", "ops.flash_attention", "ops.generation", "ops.layer_norm",
    "task.common", "task.cruller_base", "task.task_cruller_eval_ocr", "task.task_factory",
    "tokenizers.bytelevel", "tokenizers.config", "utils.name_utils",
    # training
    "app.train", "data.config", "data.loader", "data.preprocess", "data.wds",
    "framework.checkpoint", "framework.monitor", "framework.optimization",
    "framework.profiling", "framework.train", "framework.train_state", "ops.dense", "ops.loss",
    "task.task_cruller_pretrain", "utils.metrics", "utils.ocr_eval", "utils.text_metrics",
    # pretrained backbones from local files
    "models.pretrained",
    # donut_base serving, the eval CLI and the int8 decode mode
    "app.eval", "framework.eval", "models.swin", "ops.window_attention",
    # donut_base training, the remat modes and the opt-in LayerNorm kernels
    "models.remat",
    # the probe tools and their kernels
    "tools", "tools.mxu_probe", "tools.window_band_probe",
    # the finetune and eval tasks, the indexable-dataset loader, the JSON metrics
    "data.datasets_utils", "task.task_cruller_eval_cord", "task.task_cruller_eval_docvqa",
    "task.task_cruller_eval_rvlcdip", "task.task_cruller_finetune_cord",
    "task.task_cruller_finetune_docvqa", "task.task_cruller_finetune_rvlcdip",
    "task.task_cruller_finetune_xent", "utils.json_utils", "utils.tree_edit",
    # the HF Donut baseline eval task
    "task.task_donut_eval_ocr",
    # the native decoder and resizer, the re-exported building blocks, the page fixtures
    "native", "layers", "tools.make_page_fixtures",
    # checkpoints from S3 in app.train and app.eval
    "utils.s3_utils",
)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pixparse_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pixparse_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"missing = sorted(set('pixparse_tpu_torch.' + m for m in {MODULES!r}) - set(names))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + LAZY!r}\n"
        "             or m.startswith('torch.utils.tensorboard'))\n"
        "print(missing + bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: everything outside a
    function body."""
    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                yield child.module
            yield from visit(child)

    yield from visit(ast.parse(path.read_text(), str(path)))


def test_optional_packages_are_imported_only_inside_functions():
    """PIL, transformers, tokenizers, wandb, tensorboard, safetensors,
    timm, datasets, cv2 and boto3: a module of the port may use them, but only
    inside the function that needs them."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _module_level_imports(f)
        if name.split(".")[0] in LAZY or name.startswith("torch.utils.tensorboard")
    ]
    assert bad == []
    # and they are used somewhere, inside functions: the check above is not vacuous
    used = {name.split(".")[0] for f in files for name in _imports(f)} & set(LAZY)
    assert {"PIL", "wandb", "safetensors", "timm", "datasets", "transformers", "cv2",
            "boto3"} <= used


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import TaskEvalCfg, TaskTrainCfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TaskEvalCfg().device == "cuda" and TaskTrainCfg().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceEnv.initialize()
    assert DeviceEnv.initialize("cpu").device == torch.device("cpu")


def test_kernel_wrappers_route_cpu_tensors_to_plain():
    from pixparse_tpu_torch.ops import decode_attention as da
    from pixparse_tpu_torch.ops import window_attention as wa
    from pixparse_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from pixparse_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 10, 2, 32, generator=gen) for _ in range(3))
    n_flash, n_dec = flash_attention_fwd.launches, decode_attention.launches
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    qd = torch.randn(2, 1, 64, generator=gen)
    kd, vd = (torch.randn(2, 20, 64, generator=gen) for _ in range(2))
    mask_dec = torch.rand(2, 20, generator=gen) > 0.5
    assert torch.equal(
        decode_attention(qd, kd, vd, mask_dec, num_heads=2),
        decode_attention_plain(qd, kd, vd, mask_dec, num_heads=2),
    )
    # the counters count kernel launches only
    assert (flash_attention_fwd.launches, decode_attention.launches) == (n_flash, n_dec)

    n_win, n_q8 = wa.window_attention.launches, da.decode_attention_q8.launches
    qw, kw, vw = (torch.randn(4, 16, 32, generator=gen) for _ in range(3))
    bias, mask = torch.randn(2, 16, 16, generator=gen), torch.zeros(2, 16, 16)
    assert torch.equal(
        wa.window_attention(qw, kw, vw, bias, mask), wa.window_attention_plain(qw, kw, vw, bias, mask)
    )
    k_i8, ks = da.quantize_kv_rows(kd, 2)
    v_i8, vs = da.quantize_kv_rows(vd, 2)
    assert torch.equal(
        da.decode_attention_q8(qd, k_i8, v_i8, ks, vs, mask_dec, num_heads=2),
        da.decode_attention_q8_plain(qd, k_i8, v_i8, ks, vs, mask_dec, num_heads=2),
    )
    assert (wa.window_attention.launches, da.decode_attention_q8.launches) == (n_win, n_q8)


def test_training_wrappers_route_cpu_tensors_to_plain_through_autograd():
    from pixparse_tpu_torch.ops import flash_attention as fa
    from pixparse_tpu_torch.ops import loss

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 10, 2, 32, generator=gen).requires_grad_() for _ in range(3))
    h = torch.randn(2, 6, 16, generator=gen).requires_grad_()
    e = torch.randn(40, 16, generator=gen).requires_grad_()
    t = torch.randint(0, 40, (2, 6), generator=gen)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, loss.fused_ce_fwd,
                loss.fused_ce_bwd)
    before = [c.launches for c in counters]
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    loss.cross_entropy_from_hidden(h, e, t)[0].backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v, h, e))
    assert [c.launches for c in counters] == before


def test_window_backward_and_layer_norm_route_cpu_tensors_to_plain_through_autograd():
    from pixparse_tpu_torch.ops import layer_norm as ln
    from pixparse_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, 16, 32, generator=gen).requires_grad_() for _ in range(3))
    bias = torch.randn(2, 16, 16, generator=gen).requires_grad_()
    x = torch.randn(3, 5, 64, generator=gen).requires_grad_()
    w, b = torch.ones(64, requires_grad=True), torch.zeros(64, requires_grad=True)
    counters = (wa.window_attention, wa.window_attention_bwd, ln.layer_norm_fwd, ln.layer_norm_bwd)
    before = [c.launches for c in counters]
    wa.window_attention(q, k, v, bias, torch.zeros(2, 16, 16)).sum().backward()
    ln.layer_norm(x, w, b, impl="pallas").square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v, bias, x, w, b))
    assert [c.launches for c in counters] == before


def test_probe_wrappers_route_cpu_tensors_to_plain():
    from pixparse_tpu_torch.tools import mxu_probe as mp
    from pixparse_tpu_torch.tools import window_band_probe as wb

    before = (mp.mxu_dots.launches, wb.banded_attention.launches)
    a, b = mp.operands("k64x2", "cpu", m=32, n=16)
    out = mp.mxu_dots(a, b, "k64x2", dots=2, repeats=2)
    assert torch.equal(out[1], mp.mxu_dots_plain(a, b, "k64x2", dots=2))
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(1, 10, 20, 3 * 32, generator=gen)
    bias = torch.randn(2, 100, 100, generator=gen)
    assert torch.equal(
        wb.banded_attention(qkv, bias, 10, 2), wb.banded_attention_plain(qkv, bias, 10, 2)
    )
    assert (mp.mxu_dots.launches, wb.banded_attention.launches) == before


@pytest.mark.parametrize(
    "tool", ["mxu_probe", "window_band_probe", "window_variants", "window_host_time"]
)
def test_probe_tools_run_on_cuda_and_raise_without_it(monkeypatch, capsys, tool):
    import importlib

    module = importlib.import_module(f"pixparse_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
    assert capsys.readouterr().out == ""


def test_importing_the_probe_tools_runs_nothing():
    """Unlike the JAX tools, whose mxu probe runs at import: importing the
    port's prints nothing, launches nothing and touches no device."""
    code = (
        "import torch\n"
        "calls = []\n"
        "torch.cuda.synchronize = lambda *a: calls.append('synchronize')\n"
        "from pixparse_tpu_torch.tools import mxu_probe, window_band_probe\n"
        "print(calls, mxu_probe.mxu_dots.launches, window_band_probe.banded_attention.launches,\n"
        "      torch.cuda.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0 0 False"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA (or no package beside the script): non-zero exit, no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, cwd=cwd, env=env,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_the_builders_compile_only_sources_the_package_ships():
    from pixparse_tpu_torch import native
    from pixparse_tpu_torch.ops import _build

    sources = [_build.CSRC / f"{stem}.cu" for stem in _build.SIGNATURES] + [native.SOURCE]
    included = {name for src in sources
                for name in re.findall(r'#include "([^"]+)"', src.read_text())}
    sources += [_build.CSRC / name for name in sorted(included)]
    with open(ROOT / "pyproject.toml", "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["pixparse_tpu_torch"]
    assert native.SOURCE.name == "pixparse_native.cpp" and len(sources) > len(_build.SIGNATURES)
    for src in sources:
        assert src.is_file(), src
        rel = src.resolve().relative_to(PORT.resolve()).as_posix()  # raises outside the package
        assert any(fnmatch.fnmatchcase(rel, g) for g in globs), (rel, globs)
