"""The port across processes on the CPU: gloo process groups of 2 and 4
ranks in subprocesses (this file is its own worker under ``__main__``),
held against the port's one-process run and the JAX package's mesh step.

- (a) ``broadcast_object`` / ``all_gather_object`` at world 2;
- (b) 4 ranks over 6 uneven tar shards: every eval sample seen once, the
  merged metrics equal JAX's merge of the same trees;
- (c) 3 AdamW steps of ``cruller_pretrain``'s train step at ``cruller_test``
  (fp32, dropout 0) over a global batch of 8 with ragged targets (the ranks
  hold different valid counts) at meshes (2,1,1), (1,2,1) and (2,2,1): every
  loss and parameter within 1e-5 of the one-process port on the global
  batch, and within 2e-4 of the JAX step on a (2,2,1) mesh of 4 virtual
  devices (the bound of ``test_torch_train_step.py``); LAMB and the
  adaptive clip at fsdp=2 and accumulation 2 at data=2 against the
  one-process port; so are ``cruller_finetune_xent`` at fsdp=2 and
  ``pix2struct_pretrain`` (dict images, ragged patches and targets) at
  data=2; a parameter with no gradient raises;
- (d) checkpoints across world sizes: saved at fsdp=2, resumed in one
  process and at (2,2,1); saved in one process, resumed at fsdp=2;
  parameters and moments equal;
- (e) ``app.train`` (``--task.mesh.fsdp 2``), ``app.eval`` and ``app.infer``
  at 2 ranks: one set of outputs, the eval file the merge of the ranks'
  metrics, the infer JSONL the one-process one;
- (f) dropout streams differ across ranks and repeat per (seed, step, rank).

Every process group is made with a timeout and every subprocess is waited
for with one; the file takes ~1.5-2 min on one core.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOO_TIMEOUT_S = 180  # a collective waiting longer than this raises
WAIT_S = 300  # per launch: every rank must have exited by then
CHILD_TIMEOUT_S = 120  # chip_smoke's distributed child on the CPU
SCHED = (10, 1, 10)  # num_intervals, num_warmup_intervals, updates_per_interval
OPT = dict(learning_rate=1e-3, warmup_learning_rate=1e-4)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
B, L = 8, 16
STEPS = 3
# case: (data, fsdp, gradient accumulation, optimizer overrides), all at world 2
# but the (2,2,1) one
CASES = {
    "adamw_211": (2, 1, 1, {}),
    "adamw_121": (1, 2, 1, {}),
    "lamb_121": (1, 2, 1, {"optimizer": "lamb"}),
    "agc_121": (1, 2, 1, {"clip_grad_mode": "agc", "clip_grad_value": 0.01}),
    "accum2_211": (2, 1, 2, {}),
    "adamw_221": (2, 2, 1, {}),
}


# --------------------------------------------------------------------------
# shared by the workers and the tests
# --------------------------------------------------------------------------

def make_task(env, init, accum=1, dropout=None, **opt):
    """``cruller_pretrain`` at cruller_test, fp32, from the weights ``init``
    (a reference-layout state dict), its train state set up."""
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_cruller_pretrain import (
        TaskCrullerPretrain,
        TaskCrullerPretrainCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        dtype="float32", device="cpu", num_intervals=SCHED[0], num_warmup_intervals=SCHED[1],
        opt=OptimizationCfg(grad_accum_steps=accum, **{**OPT, **opt}),
    )
    task = TaskCrullerPretrain(cfg, env)
    drop = NO_DROPOUT if dropout is None else {k: dropout for k in NO_DROPOUT}
    task.bart_cfg = dataclasses.replace(task.bart_cfg, **drop)
    task.resume_state_dict = dict(init)
    task.train_setup(num_batches_per_interval=SCHED[2] * accum, seed=0)
    return task


def global_batch(vocab, accum=1, seed=0):
    """``accum`` micro-batches of 8 rows (stacked when accum > 1); row i of
    a micro-batch ignores its last 2*i (+ micro index) targets."""
    rng = np.random.RandomState(seed)
    micro = []
    for a in range(accum):
        txt = rng.randint(4, vocab, size=(B, L)).astype(np.int32)
        tgt = np.roll(txt, -1, axis=1).astype(np.int32)
        for i in range(B):
            tgt[i, L - 1 - 2 * i - a:] = -100
        micro.append({"image": rng.randn(B, 64, 48, 1).astype(np.float32),
                      "text": txt, "target": tgt})
    if accum == 1:
        return micro[0]
    return {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def rank_slice(batch, rank, world, stacked=False):
    """This rank's rows of a (nested) batch of ``B`` rows."""
    n = B // world
    if isinstance(batch, dict):
        return {k: rank_slice(v, rank, world, stacked) for k, v in batch.items()}
    return batch[:, rank * n:(rank + 1) * n] if stacked else batch[rank * n:(rank + 1) * n]


# the other train setups: (task, model, data, fsdp)
OTHER_TASKS = {
    "xent_121": ("cruller_finetune_xent", "cruller_test", 1, 2),
    "p2s_211": ("pix2struct_pretrain", "pix2struct_test", 2, 1),
}


def make_other_task(name, env):
    """The finetune classifier or pix2struct's pretrain task at its test
    size, fp32, dropout 0, seeded init, its train state set up."""
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    task_name, model_name, _, _ = OTHER_TASKS[name]
    cls, cfg_cls = TASK_CLASS_REGISTRY[task_name]
    cfg = cfg_cls(model_name=model_name, tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
                  dtype="float32", device="cpu", num_intervals=SCHED[0],
                  num_warmup_intervals=SCHED[1], opt=OptimizationCfg(**OPT))
    task = cls(cfg, env)
    task.bart_cfg = dataclasses.replace(task.bart_cfg, **NO_DROPOUT)
    task.train_setup(num_batches_per_interval=SCHED[2], seed=0)
    return task


def other_batch(name, task):
    """8 seeded rows in the task's step layout: RVL-CDIP-like labels, or
    pages of eight sizes patchified (ragged real patches) with ragged
    targets."""
    from pixparse_tpu_torch.data.wds import default_collate

    rng = np.random.RandomState(5)
    if name.startswith("xent"):
        return {"image": rng.randn(B, 64, 48, 1).astype(np.float32),
                "label": rng.randint(0, 16, B).astype(np.int32)}
    L = task.max_position_embeddings
    samples = []
    for i in range(B):
        page = rng.randint(0, 255, (60 + 40 * i, 240 - 20 * i), np.uint8)
        txt = rng.randint(4, 200, (L,)).astype(np.int64)
        tgt = txt.copy()
        tgt[L - 1 - 2 * i:] = -100
        samples.append((task.image_preprocess_train(page), txt, tgt))
    return task.normalize_batch(default_collate(samples))


def run_steps(task, batch):
    losses, norms = [], []
    for _ in range(STEPS):
        task.state, m = task.train_step_fn(task.state, task._to_device(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def whole(t):
    from pixparse_tpu_torch.parallel.mesh import is_sharded

    return (t.full_tensor() if is_sharded(t) else t).detach().clone()


def state_dump(state):
    """Every parameter and moment whole (a collective under a mesh)."""
    out = {"params": {k: whole(v) for k, v in state.params.items()}, "step": state.step,
           "count": int(state.opt_state["count"])}
    for moment in ("mu", "nu"):
        out[moment] = {k: whole(v) for k, v in state.opt_state[moment].items()}
    return out


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _worker(mode, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", timeout=timedelta(seconds=GLOO_TIMEOUT_S))
    rank = dist.get_rank()
    torch.set_num_threads(2)
    if mode == "core":
        _core(out_dir)
    elif mode == "quad":
        _quad(out_dir)
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def _save(out_dir, name, obj):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out_dir, f"{name}.pt"))


def _case(out_dir, name, init):
    import torch.distributed as dist

    from pixparse_tpu_torch.parallel.mesh import MeshEnv

    data, fsdp, accum, opt = CASES[name]
    env = MeshEnv.initialize(data=data, fsdp=fsdp, device="cpu")
    task = make_task(env, init, accum, **opt)
    batch = rank_slice(global_batch(task.vocab_size, accum), env.global_rank, env.world_size,
                       stacked=accum > 1)
    losses, norms = run_steps(task, batch)
    every = env.all_gather_object((losses, norms))
    assert all(e == every[0] for e in every), every  # the same metrics on every rank
    sharded = sum(v.to_local().numel() < v.numel() for v in task.state.params.values())
    _save(out_dir, name, {"losses": losses, "norms": norms, "sharded_params": sharded,
                          **state_dump(task.state)})
    dist.barrier()
    return env, task


def _core(out_dir):
    """World 2: (a), the world-2 cases of (c), (d)'s sharded save and its
    one-process resume, (f)."""
    import torch.distributed as dist

    from pixparse_tpu_torch.framework.checkpoint import restore_train_state, save_checkpoint
    from pixparse_tpu_torch.parallel.mesh import MeshEnv

    rank = dist.get_rank()
    env = MeshEnv.initialize(device="cpu")
    objects = {"broadcast": env.broadcast_object(f"exp-{rank}" if rank == 0 else None),
               "gathered": env.all_gather_object({"rank": rank}), "str": str(env)}
    _save(out_dir, "objects", objects)

    init = torch.load(os.path.join(out_dir, "init.pt"))
    for name in ("adamw_211", "lamb_121", "agc_121", "accum2_211"):
        _case(out_dir, name, init)
    env, task = _case(out_dir, "adamw_121", init)
    save_checkpoint(os.path.join(out_dir, "ckpt_121"), task.state,
                    metadata={"interval": 0, "step": task.state.step})

    for name, (_, _, data, fsdp) in OTHER_TASKS.items():
        env = MeshEnv.initialize(data=data, fsdp=fsdp, device="cpu")
        task = make_other_task(name, env)
        losses, norms = run_steps(task, rank_slice(other_batch(name, task), rank, env.world_size))
        _save(out_dir, name, {"losses": losses, "norms": norms, **state_dump(task.state)})

    # (d) the one-process checkpoint into a fresh fsdp=2 state
    fresh = make_task(env, init)
    state, meta = restore_train_state(os.path.join(out_dir, "ckpt_alone"), fresh.state)
    _save(out_dir, "resume_alone_at_121", {"meta": meta, **state_dump(state)})

    # a parameter that needs a gradient and gets none
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.optimization import create_optimizer
    from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step

    class Partial(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = torch.nn.Linear(4, 4)
            self.unused = torch.nn.Linear(4, 4)

        def forward(self, x):
            return self.used(x)

    model = Partial()
    optimizer, _ = create_optimizer(OptimizationCfg(), 1, 0, 1)
    state = create_train_state(model, optimizer, mesh=env.mesh)
    step = make_train_step(lambda b: (model(b).sum(), {}), optimizer, mesh=env.mesh, module=model)
    try:
        step(state, torch.ones(2, 4))
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    _save(out_dir, "no_grad", {"raised": raised})

    # (f) the dropout streams a step draws, rank by rank
    import pixparse_tpu_torch.framework.train_state as train_state

    seeds = []
    drawn = train_state.dropout_seed

    def recording(*args):
        seeds.append((args, drawn(*args)))
        return seeds[-1][1]

    train_state.dropout_seed = recording
    try:
        env = MeshEnv.initialize(data=2, device="cpu")
        task = make_task(env, init, dropout=0.5)
        batch = rank_slice(global_batch(task.vocab_size), env.global_rank, env.world_size)
        for _ in range(2):
            task.state, _ = task.train_step_fn(task.state, task._to_device(batch))
    finally:
        train_state.dropout_seed = drawn
    _save(out_dir, "dropout", {"seeds": env.all_gather_object(seeds)})


def _quad(out_dir):
    """World 4: the (2,2,1) case of (c), (d)'s resume at (2,2,1), (b)."""
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state
    from pixparse_tpu_torch.parallel.mesh import MeshEnv

    init = torch.load(os.path.join(out_dir, "init.pt"))
    env, _ = _case(out_dir, "adamw_221", init)
    fresh = make_task(env, init)
    state, meta = restore_train_state(os.path.join(out_dir, "ckpt_121"), fresh.state)
    _save(out_dir, "resume_121_at_221", {"meta": meta, **state_dump(state)})

    # (b) 6 shards over 4 ranks: an uneven split
    import glob

    from pixparse_tpu_torch.app.eval import _merge_metric_trees
    from pixparse_tpu_torch.data.wds import WdsLoader

    env = MeshEnv.initialize(device="cpu")
    shards = sorted(glob.glob(os.path.join(out_dir, "shards", "*.tar")))
    loader = WdsLoader(
        shards=shards, decoder=lambda s: {"key": s["__key__"]}, batch_size=2, is_train=False,
        num_batches=10**6, world_size=env.world_size, global_rank=env.global_rank,
        num_workers=1, collate_fn=lambda samples: {"key": [s["key"] for s in samples]},
    )
    seen = [k for batch in loader for k in batch["key"]]
    rank = env.global_rank
    local_metrics = {"cer": 0.1 * (rank + 1), "wer": 0.05 * rank, "num_samples": len(seen),
                     "nested": {"correct": rank, "accuracy": 1.0 / (rank + 1)}}
    trees = env.all_gather_object(local_metrics)
    _save(out_dir, "data_plane", {"seen": env.all_gather_object(seen), "trees": trees,
                                  "merged": _merge_metric_trees(trees)})


# --------------------------------------------------------------------------
# launching
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, argv, module=False, script=__file__):
    """``world`` ranks of ``python <script> argv`` (``script``: this file
    by default; or ``python -m argv[0] argv[1:]``) as torchrun would start
    them; returns their outputs after all have exited 0."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", *argv] if module else [sys.executable, script, *argv]
    procs = [
        subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} of {cmd} failed:\n{out[-6000:]}"
    return outputs


# --------------------------------------------------------------------------
# the references and the runs, made once
# --------------------------------------------------------------------------

def _jax_mesh_steps(init_params, vocab, steps=STEPS):
    """The JAX train step on a (2,2,1) mesh of 4 virtual devices: losses and
    the final parameters in the port's names."""
    import jax
    import jax.numpy as jnp

    from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
    from pixparse_tpu.framework.optimization import create_optimizer as jax_create_optimizer
    from pixparse_tpu.framework.train_state import make_train_step as jax_make_train_step
    from pixparse_tpu.ops import loss as jax_loss
    from pixparse_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax

    model, mesh, state, jv, jb = init_params
    depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
    tx, _ = jax_create_optimizer(JaxOptCfg(**OPT), *SCHED, **depth, wrap_multisteps=False)

    def loss_fn(params, batch, rng):
        hidden = model.apply({"params": params}, batch["image"], batch["text"],
                             deterministic=False, rngs={"dropout": rng}, method="forward_hidden")
        emb = params["text_decoder"]["embed_tokens"]["embedding"]
        return jax_loss.cross_entropy_from_hidden(hidden, emb.astype(hidden.dtype),
                                                  batch["target"])[0], {}

    step = jax_make_train_step(loss_fn, tx, mesh, donate=False)
    batch = jax_shard_batch(mesh, global_batch(vocab))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    return losses, cruller_state_dict_from_jax(params, jv, jb, tied_head=False)


def _jax_init(vocab):
    import jax
    import jax.numpy as jnp

    from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
    from pixparse_tpu.framework.optimization import create_optimizer as jax_create_optimizer
    from pixparse_tpu.framework.train_state import create_train_state as jax_create_train_state
    from pixparse_tpu.models import Cruller as JaxCruller
    from pixparse_tpu.models import get_model_config as jax_model_config
    from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
    from pixparse_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax

    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=vocab)
    jb = dataclasses.replace(jb, **NO_DROPOUT)
    model = JaxCruller(jv, jb, attn_impl="xla")
    mesh = jax_create_mesh(2, 2, 1, devices=jax.devices()[:4])
    depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
    tx, _ = jax_create_optimizer(JaxOptCfg(**OPT), *SCHED, **depth, wrap_multisteps=False)
    example = (jnp.zeros((B, 64, 48, 1)), jnp.zeros((B, L), jnp.int32))
    state, _ = jax_create_train_state(model, tx, mesh, example, seed=0)
    init = cruller_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), jv, jb)
    return (model, mesh, state, jv, jb), init


def _make_tar_shards(shard_dir, n_shards=6, per_shard=4):
    import io
    import tarfile

    os.makedirs(shard_dir, exist_ok=True)
    for s in range(n_shards):
        with tarfile.open(os.path.join(shard_dir, f"shard-{s:05d}.tar"), "w") as tf:
            for i in range(per_shard):
                payload = json.dumps({"id": f"s{s}_{i}"}).encode()
                info = tarfile.TarInfo(f"s{s}_{i:02d}.json")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))


def task_vocab():
    """The vocabulary of ``make_task``'s tokenizer (byte-level + the
    pretrain tokens)."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_pretrain import (
        TaskCrullerPretrain,
        TaskCrullerPretrainCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerPretrainCfg(model_name="cruller_test", device="cpu",
                                 tokenizer=TokenizerCfg(name="pixparse_bytelevel"))
    return TaskCrullerPretrain(cfg, DeviceEnv(torch.device("cpu"))).vocab_size


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX init, the one-process port run of every case, the world-2
    launch, the JAX (2,2,1) step, then the world-4 launch."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import save_checkpoint

    out = str(tmp_path_factory.mktemp("dist"))
    alone = DeviceEnv(torch.device("cpu"))
    vocab = task_vocab()
    jax_init, init = _jax_init(vocab)
    torch.save(init, os.path.join(out, "init.pt"))
    _make_tar_shards(os.path.join(out, "shards"))

    refs = {}
    for name, (_, _, accum, opt) in CASES.items():
        key = (accum, tuple(sorted(opt.items())))
        if key not in refs:
            task = make_task(alone, init, accum, **opt)
            losses, norms = run_steps(task, global_batch(vocab, accum))
            refs[key] = {"losses": losses, "norms": norms, **state_dump(task.state)}
            if not opt and accum == 1:
                save_checkpoint(os.path.join(out, "ckpt_alone"), task.state,
                                metadata={"interval": 0, "step": task.state.step})
        refs[name] = refs[key]

    for name in OTHER_TASKS:
        task = make_other_task(name, alone)
        losses, norms = run_steps(task, other_batch(name, task))
        refs[name] = {"losses": losses, "norms": norms, **state_dump(task.state)}

    outputs = launch(2, ["core", out])
    jax_losses, jax_params = _jax_mesh_steps(jax_init, vocab)
    outputs += launch(4, ["quad", out])
    return dict(out=out, refs=refs, jax=(jax_losses, jax_params), outputs=outputs,
                init=init, vocab=vocab)


def load(runs, name):
    return torch.load(os.path.join(runs["out"], f"{name}.pt"), weights_only=False)


def assert_state_close(got, want, atol, what):
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what}: {k}")


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def test_object_collectives_at_world_two(runs):
    objects = load(runs, "objects")
    assert objects["broadcast"] == "exp-0"
    assert objects["gathered"] == [{"rank": 0}, {"rank": 1}]
    assert objects["str"].startswith("MeshEnv(process 0/2, device=cpu, mesh={'data': 2")


def test_four_ranks_over_uneven_shards_see_each_sample_once(runs):
    from pixparse_tpu.app.eval import _merge_metric_trees as jax_merge

    plane = load(runs, "data_plane")
    seen = plane["seen"]
    flat = [k for part in seen for k in part]
    assert len(flat) == len(set(flat)) == 24  # 6 shards x 4 samples, none twice
    assert sorted(len(part) for part in seen) == [4, 4, 8, 8]  # uneven
    assert plane["merged"] == jax_merge(plane["trees"])
    assert plane["merged"]["num_samples"] == 24


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_steps_equal_the_process_alone(runs, name):
    got, want = load(runs, name), runs["refs"][name]
    data, fsdp, _, _ = CASES[name]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=1e-5, rtol=1e-5)
    assert got["step"] == want["step"] == STEPS and got["count"] == want["count"] == STEPS
    assert (got["sharded_params"] > 0) == (fsdp > 1)  # fsdp=1 replicates only
    assert_state_close(got, want, 1e-5, name)
    for moment in ("mu", "nu"):
        for k, v in want[moment].items():
            np.testing.assert_allclose(got[moment][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name} {moment} {k}")


@pytest.mark.parametrize("name", sorted(OTHER_TASKS))
def test_the_other_train_tasks_at_two_ranks_equal_the_process_alone(runs, name):
    """``cruller_finetune_xent`` (the classifier: its root is the model's
    ``forward``) at fsdp=2 and ``pix2struct_pretrain`` (dict images,
    ``kv_lens`` through the blocks, ragged targets) at data=2."""
    got, want = load(runs, name), runs["refs"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=1e-5, rtol=1e-5)
    assert_state_close(got, want, 1e-5, name)


def test_the_2x2_mesh_step_follows_the_jax_mesh_step(runs):
    jax_losses, jax_params = runs["jax"]
    got = load(runs, "adamw_221")
    np.testing.assert_allclose(got["losses"], jax_losses, atol=2e-4, rtol=0)
    for k, v in jax_params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=2e-4, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adamw_211", "adamw_121", "adamw_221"])
def test_every_mesh_follows_the_jax_losses(runs, name):
    jax_losses, _ = runs["jax"]
    np.testing.assert_allclose(load(runs, name)["losses"], jax_losses, atol=2e-4, rtol=0)


def test_a_parameter_without_gradient_raises(runs):
    raised = load(runs, "no_grad")["raised"]
    assert "got none" in raised and "unused.weight" in raised


def _equal_states(got, want, what):
    for part in ("params", "mu", "nu"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), f"{what}: {part} {k}"
    assert got["step"] == want["step"] and got["count"] == want["count"]


def test_a_sharded_checkpoint_resumes_in_one_process_and_at_2x2(runs):
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state

    saved = load(runs, "adamw_121")
    names = sorted(os.listdir(os.path.join(runs["out"], "ckpt_121")))
    assert "metadata.json" in names and ".metadata" in names
    assert sum(n.endswith(".distcp") for n in names) == 2  # one file per rank
    at_221 = load(runs, "resume_121_at_221")
    assert at_221["meta"] == {"interval": 0, "step": STEPS}
    _equal_states(at_221, saved, "fsdp=2 -> (2,2,1)")

    task = make_task(DeviceEnv(torch.device("cpu")), runs["init"])
    state, meta = restore_train_state(os.path.join(runs["out"], "ckpt_121"), task.state)
    assert meta == {"interval": 0, "step": STEPS}
    assert state.params["image_encoder.trunk.blocks.0.attn.qkv.weight"] is \
        task.model.encoder.blocks[0].attn.qkv.weight  # filled in place
    _equal_states(state_dump(state), saved, "fsdp=2 -> one process")


def test_a_one_process_checkpoint_resumes_at_fsdp_two(runs):
    got = load(runs, "resume_alone_at_121")
    assert got["meta"] == {"interval": 0, "step": STEPS}
    _equal_states(got, runs["refs"]["adamw_211"], "one process -> fsdp=2")


def test_dropout_streams_differ_across_ranks_and_repeat(runs):
    from pixparse_tpu_torch.framework.train_state import dropout_seed
    from pixparse_tpu_torch.ops.dense import dropout

    by_rank = load(runs, "dropout")["seeds"]
    assert len(by_rank) == 2 and all(len(calls) == 2 for calls in by_rank)  # 2 steps each
    for rank, calls in enumerate(by_rank):
        for step, (args, seed) in enumerate(calls):
            assert args[-1] == rank and args[1] == step
            assert seed == dropout_seed(*args)  # a restart at (seed, step, rank) repeats it

    def mask(seed):
        return dropout(torch.ones(4096), 0.5, True, torch.Generator().manual_seed(seed)) > 0

    for step in range(2):
        m0, m1 = (mask(by_rank[r][step][1]) for r in range(2))
        assert not torch.equal(m0, m1)
        assert torch.equal(m0, mask(by_rank[0][step][1]))



# --------------------------------------------------------------------------
# (e) the entry points at 2 ranks
# --------------------------------------------------------------------------

def _pages(page_dir, n=5):
    from PIL import Image

    os.makedirs(page_dir, exist_ok=True)
    rng = np.random.RandomState(3)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (64, 48), np.uint8), "L").save(
            os.path.join(page_dir, f"page{i}.png"))
    return page_dir


def _decoding_weights(trained, path):
    """``trained``'s tensors redrawn at the scales of
    ``test_torch_eval_cli.py`` (seeded), so greedy decoding writes text and
    CER/WER exist; the tied table and head drawn alike."""
    rng = np.random.RandomState(0)
    out = {}
    for name, t in sorted(trained.items()):
        if "norm" in name:
            out[name] = t
            continue
        std = (0.5 if ("embed_tokens" in name or "lm_head" in name or "cls_token" in name)
               else 0.1 if "pos" in name else 0.05 if name.endswith("bias") else 0.15)
        draw_rng = np.random.RandomState(7) if std == 0.5 and "cls" not in name else rng
        out[name] = torch.from_numpy(draw_rng.normal(0.0, std, tuple(t.shape)).astype(np.float32))
    torch.save(out, path)
    return path


def _eval_flags(source, ckpt, out_dir, n):
    return ["--eval.task_name", "cruller_eval_ocr", "--eval.output_dir", out_dir,
            "--eval.checkpoint_path", ckpt, "--eval.dataset_name", "FUNSD",
            "--task.model_name", "cruller_test", "--task.tokenizer.name", "pixparse_bytelevel",
            "--task.dtype", "float32", "--task.device", "cpu",
            "--data.eval.source", source, "--data.eval.num_samples", str(n),
            "--data.eval.batch_size", "4", "--data.eval.split", "eval",
            "--data.eval.num_workers", "1"]


def _infer_flags(pages, ckpt, out):
    return ["--infer.task_name", "cruller_eval_ocr", "--infer.images", pages,
            "--infer.checkpoint_path", ckpt, "--infer.output", out, "--infer.batch_size", "2",
            "--infer.max_new_tokens", "8", "--task.model_name", "cruller_test",
            "--task.tokenizer.name", "pixparse_bytelevel", "--task.dtype", "float32",
            "--task.device", "cpu"]


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """``app.train`` at fsdp=2 for 2 intervals, then ``app.eval`` and
    ``app.infer`` at 2 ranks from its last ``.pt``."""
    from test_torch_train_cli import _make_shard

    d = str(tmp_path_factory.mktemp("apps"))
    _make_shard(os.path.join(d, "train.tar"), 32)
    for s in range(2):
        _make_shard(os.path.join(d, f"eval-{s}.tar"), 8, seed=10 + s)
    out = os.path.join(d, "train")
    train = launch(2, [
        "pixparse_tpu_torch.app.train", "--train.task_name", "cruller_pretrain",
        "--train.output_dir", out, "--train.seed", "42", "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel", "--task.num_intervals", "2",
        "--task.num_warmup_intervals", "1", "--task.opt.learning_rate", "1e-4",
        "--task.dtype", "float32", "--task.device", "cpu", "--task.mesh.fsdp", "2",
        "--data.train.source", os.path.join(d, "train.tar"), "--data.train.num_samples", "16",
        "--data.train.batch_size", "4", "--data.train.split", "train",
        "--data.train.num_workers", "2",
    ], module=True)
    (experiment,) = os.listdir(out)
    ckpt_dir = os.path.join(out, experiment, "checkpoints", experiment)
    ckpt = os.path.join(ckpt_dir, "checkpoint-1.pt")
    decoding = _decoding_weights(torch.load(ckpt, weights_only=True), os.path.join(d, "eval.pt"))
    evals = launch(2, ["pixparse_tpu_torch.app.eval", *_eval_flags(
        os.path.join(d, "eval-{0..1}.tar"), decoding, os.path.join(d, "eval"), 16)], module=True)
    pages = _pages(os.path.join(d, "pages"))
    infers = launch(2, ["pixparse_tpu_torch.app.infer", *_infer_flags(
        pages, decoding, os.path.join(d, "infer", "ocr.jsonl"))], module=True)
    return dict(dir=d, out=out, experiment=experiment, ckpt_dir=ckpt_dir, ckpt=ckpt,
                decoding=decoding, pages=pages, outputs=(train, evals, infers))


def test_train_app_at_two_ranks_writes_one_set_of_outputs(apps):
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state

    exp_dir = os.path.join(apps["out"], apps["experiment"])
    assert apps["experiment"].split("-task_")[1].startswith("cruller_pretrain-model_cruller_test")
    assert sorted(os.listdir(apps["ckpt_dir"])) == [
        "checkpoint-0", "checkpoint-0.pt", "checkpoint-1", "checkpoint-1.pt"]
    for i in range(2):
        names = os.listdir(os.path.join(apps["ckpt_dir"], f"checkpoint-{i}"))
        assert sorted(n for n in names if n.endswith(".distcp")) == ["__0_0.distcp", "__1_0.distcp"]
        with open(os.path.join(apps["ckpt_dir"], f"checkpoint-{i}", "metadata.json")) as fh:
            assert json.load(fh) == {"interval": i, "step": 2 * (i + 1)}
    with open(os.path.join(exp_dir, "out.log")) as fh:
        log = fh.read()
    assert log.count("TaskCrullerPretrainCfg(") == 1  # only rank 0 writes the log
    assert log.count("saved sharded checkpoint") == 2  # one line per interval
    assert "mesh=MeshCfg(data=0, fsdp=2, model=1)" in log
    # the .pt holds the sharded checkpoint's weights, gathered whole
    task = make_task(DeviceEnv(torch.device("cpu")),
                     torch.load(apps["ckpt"], weights_only=True))
    state, meta = restore_train_state(os.path.join(apps["ckpt_dir"], "checkpoint-1"), task.state)
    weights = torch.load(apps["ckpt"], weights_only=True)
    assert meta == {"interval": 1, "step": 4} and state.step == 4
    for k, v in state.params.items():
        assert torch.equal(v.detach(), weights[k]), k


def test_eval_app_at_two_ranks_writes_the_merged_metrics(apps, tmp_path):
    from pixparse_tpu_torch.app.eval import _merge_metric_trees, main as eval_main
    from pixparse_tpu_torch.app.eval import metrics_file_name

    name = metrics_file_name(apps["decoding"], "FUNSD")
    assert sorted(os.listdir(os.path.join(apps["dir"], "eval"))) == sorted([name, "out.log"])
    with open(os.path.join(apps["dir"], "eval", name)) as fh:
        got = json.load(fh)
    per_rank = []
    for s in range(2):  # rank s evaluates shard s: each as one process alone
        out_dir = str(tmp_path / f"alone{s}")
        assert eval_main(_eval_flags(os.path.join(apps["dir"], f"eval-{s}.tar"),
                                     apps["decoding"], out_dir, 8)) == 0
        with open(os.path.join(out_dir, name)) as fh:
            per_rank.append(json.load(fh))
    want = _merge_metric_trees(per_rank)
    assert got.keys() == want.keys() == {"eval"}
    assert set(got["eval"]["average"]) == {"cer", "wer"}
    assert got["eval"]["average"] == pytest.approx(want["eval"]["average"], rel=1e-6)
    assert per_rank[0] != per_rank[1]  # the ranks did see different pages


def test_infer_app_at_two_ranks_writes_the_one_process_jsonl(apps, tmp_path):
    from pixparse_tpu_torch.app.infer import main as infer_main

    alone = str(tmp_path / "alone.jsonl")
    assert infer_main(_infer_flags(apps["pages"], apps["decoding"], alone)) == 0
    with open(alone) as fh:
        want = fh.read()
    assert os.listdir(os.path.join(apps["dir"], "infer")) == ["ocr.jsonl"]
    with open(os.path.join(apps["dir"], "infer", "ocr.jsonl")) as fh:
        got = fh.read()
    assert got == want
    records = [json.loads(line) for line in got.splitlines()]
    assert any(r["text"] for r in records)
    files = [r["file"] for r in records]
    assert files == sorted(os.path.join(apps["pages"], f) for f in os.listdir(apps["pages"]))



def test_chip_smoke_distributed_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``distributed`` phase on the CPU at cruller_test: its
    torchrun child (one gloo rank) passes its own checks (the FSDP2-wrapped
    step against the process alone, equal launches, equal eval metrics
    through ``app.eval``) and the phase records both runs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    # a hang fails within this, not at the suite's limit (the child takes ~15 s)
    monkeypatch.setattr(cs, "DIST_CHILD_TIMEOUT_S", CHILD_TIMEOUT_S)
    os.makedirs(cs.OUT_DIR)
    counts = cs.phase_distributed(torch, model_name="cruller_test", B=2, steps=3, vocab=300,
                                  eval_run=(2, 1, 16), device="cpu")
    assert not any(counts["distributed"].values())  # no kernel on the CPU
    rec = json.loads((tmp_path / "out" / "phases.jsonl").read_text().splitlines()[-1])
    assert rec["phase"] == "distributed" and rec["backend"] == "gloo" and rec["world_size"] == 1
    assert rec["runs"]["mesh"]["fsdp2_wrapped"] and not rec["runs"]["alone"]["fsdp2_wrapped"]
    assert rec["runs"]["mesh"]["model_class"].startswith("FSDP")
    assert rec["step1"]["loss_rel"] <= 1e-3 and rec["problems"] == []
    assert rec["eval"]["mesh"]["metrics"] == rec["eval"]["alone"]["metrics"]


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
