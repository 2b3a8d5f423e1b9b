"""The expert-layer driver (``drivers/moe_train.py``) end to end on the CPU
at a test-size copy of ``cruller_moonlight`` (``tests/data_moe``): it reads
``correct: true``; one token-slot sent to the wrong expert reads ``correct:
false``; the fp8 control fails where the program passes. Also the grouped
kernels' names fall in the breakdown's ``other`` family, and a program
without the configuration's model fails at once."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import checkout

CELL = "cruller_moonlight_test.pretrain"
FULL = "cruller_moonlight.pretrain"
DATA = os.path.join(checkout.HERE, "data_moe")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A scratch checkout with the test-size configuration and cell, listed
    in BENCHMARK.json wherever the full-size cell is."""
    root = checkout.make(str(tmp_path_factory.mktemp("checkout")), cells=["cruller_test.pretrain"])
    for kind in ("configs", "workloads"):
        for name in os.listdir(os.path.join(DATA, kind)):
            shutil.copy(os.path.join(DATA, kind, name), os.path.join(root, "benchmark", kind, name))
    path = os.path.join(root, "BENCHMARK.json")
    bench = checkout.load(path)
    bench["configs"].append({"name": "cruller_moonlight_test", "source": "test size", "reduced": [],
                             "file": "benchmark/configs/cruller_moonlight_test.json",
                             "why": "test size"})
    bench["workloads"].append({"name": CELL, "config": "cruller_moonlight_test",
                               "traffic": "pretrain", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if FULL in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(path, "w") as fh:
        json.dump(bench, fh, indent=2)
    return root


def run(root, seed=2**31 + 9, trace=0, fault=None):
    code = ("import sys; sys.path.insert(0, {bench!r}); sys.path.insert(0, {tests!r})\n"
            "import run\n{fault}sys.exit(run.main({argv!r}, device='cpu'))\n").format(
        bench=os.path.join(root, "benchmark"), tests=checkout.HERE,
        fault=f"import faults_moe; faults_moe.{fault}()\n" if fault else "",
        argv=["--workload", CELL, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)])
    env = dict(os.environ, PYTHONPATH=checkout.REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)


def test_driver_reads_correct_at_the_test_size(root):
    proc = run(root, trace=1)
    line = checkout.last_line(proc)
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == ["loss_gap", "grad_gap", "delta_gap", "route_gap"]
    assert line["checks"]["route_gap"]["value"] == 0.0
    window = json.loads(proc.stderr.strip().splitlines()[-5])["window"]
    rows = window["expert_rows"]  # the device tally, read once after the collected pass
    assert sorted(rows) == ["moe.expert_rows.1", "moe.expert_rows.2"]
    assert all(sum(v) == 2 * 2 * (13 + 31) * 3 for v in rows.values())  # steps x B x L x k
    assert window["moe_route_ms"] > 0


def test_one_slot_sent_to_the_wrong_expert_is_not_correct(root):
    line = checkout.last_line(run(root, fault="one_slot_misrouted"))
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["route_gap"]["value"] > line["checks"]["route_gap"]["limit"]


def test_the_control_fails_where_the_program_passes(root):
    out = os.path.join(root, "control-out")
    proc = checkout.run_control(root, CELL, seeds="21,22,23", out=out)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = checkout.load(os.path.join(DATA, "workloads", f"{CELL}.json"))["check"]["limits"]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert all(line["program"][k] <= v for k, v in limits.items()), line
        assert any(line["control"][k] > v for k, v in limits.items()), line


def test_the_parent_program_without_the_model_fails_at_once(root, monkeypatch):
    """A checkout of the program without ``cruller_moonlight`` (as the
    commit before it) exits with an error before building anything."""
    cfg_dir = os.path.join(root, "benchmark", "configs")
    spec = checkout.load(os.path.join(cfg_dir, "cruller_moonlight_test.json"))
    spec["program_model"] = "no_such_model"
    with open(os.path.join(cfg_dir, "cruller_moonlight_test.json"), "w") as fh:
        json.dump(spec, fh)
    try:
        proc = run(root)
    finally:
        shutil.copy(os.path.join(DATA, "configs", "cruller_moonlight_test.json"), cfg_dir)
    assert proc.returncode != 0 and "no model 'no_such_model'" in proc.stderr


def test_grouped_kernels_fall_in_the_other_family():
    from bench_lib.families import family_of

    for name in ("void (anonymous namespace)::moe_expert_mm_kernel<0>(__nv_bfloat16 const*, "
                 "__nv_bfloat16 const*, __nv_bfloat16*, int const*, int, int, int)",
                 "void (anonymous namespace)::moe_expert_wgrad_kernel(__nv_bfloat16 const*, "
                 "__nv_bfloat16 const*, __nv_bfloat16*, int const*, int, int)"):
        assert family_of(name) == "other"


def test_the_configuration_holds_the_published_config():
    """Every key of the published config.json is in the file as published,
    but ``num_hidden_layers``, which BENCHMARK.json lists as reduced."""
    cfg = checkout.load(os.path.join(checkout.BENCH, "configs", "cruller_moonlight.json"))
    published = {"hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16,
                 "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 11264,
                 "moe_intermediate_size": 1408, "n_routed_experts": 64, "n_shared_experts": 2,
                 "num_experts_per_tok": 6, "first_k_dense_replace": 1,
                 "routed_scaling_factor": 2.446, "norm_topk_prob": True, "rms_norm_eps": 1e-05,
                 "rope_theta": 50000, "vocab_size": 163840, "tie_word_embeddings": False,
                 "topk_method": "noaux_tc", "scoring_func": "sigmoid", "n_group": 1,
                 "topk_group": 1}
    bench = checkout.load(os.path.join(checkout.REPO, "BENCHMARK.json"))
    entry = next(c for c in bench["configs"] if c["name"] == "cruller_moonlight")
    changed = {k for k, v in published.items() if cfg[k] != v}
    assert changed == set(entry["reduced"]) == {"num_hidden_layers"}
    assert cfg["decoder"]["vocab_size"] == cfg["vocab_size"]
    assert cfg["decoder"]["d_model"] == cfg["hidden_size"]
