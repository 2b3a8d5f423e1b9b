"""The whole-word import check: what the benchmark and the reference load
holds no module whose top-level name is jax, jaxlib, flax or pixparse_tpu,
and the reference loads nothing of the program (pixparse_tpu_torch)."""

import json
import os
import subprocess
import sys

from bench_lib import env
from checkout import BENCH, REPO

PROBE = """
import sys, json
sys.path.insert(0, {bench!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(imports: str):
    code = PROBE.format(bench=BENCH, imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    top = loaded("import reference.model, reference.train, reference.numerics")
    assert not top & {"jax", "jaxlib", "flax", "pixparse_tpu", "pixparse_tpu_torch"}


def test_the_harness_and_its_drivers_load_no_jax():
    top = loaded(
        "import run, control\n"
        "from bench_lib import cells, compare, env, flops, bounds, tracing, weights, traffic, program\n"
        "for d in ('train', 'greedy_eval'):\n"
        "    cells._module(f'{bench}/drivers/{d}.py', 'd_' + d)\n"
        "from bench_lib.program import make_task, counters, tokenizer_dir\n"
        "counters()\n"
        "import pixparse_tpu_torch.task.task_factory, pixparse_tpu_torch.ops.generation\n"
        .replace("{bench}", BENCH))
    assert "pixparse_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pixparse_tpu"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pixparse_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert env.forbidden_modules() == [] or set(env.forbidden_modules()) <= set(env.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "pixparse_tpu.fake", object())
    assert "pixparse_tpu" in env.forbidden_modules()


def test_without_a_card_run_prints_no_result(tmp_path):
    code = f"import sys; sys.path.insert(0, {BENCH!r}); import run; run.main(['--workload', 'cruller_base.pretrain', '--seed', '1', '--seconds', '1'])"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
                          cwd=REPO, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_in_a_directory_of_the_benchmark_alone_run_fails(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns(".cache"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env_ = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cruller_base.pretrain",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          env=env_, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
