"""Tensor parallelism (the mesh's ``model`` axis) on the CPU: gloo process
groups of 2 and 4 ranks in subprocesses (this file is its own worker under
``__main__``), held against the port's one-process run and the JAX
package's mesh step at the same mesh.

- 3 AdamW steps of ``cruller_pretrain``'s train step at ``cruller_test``
  (fp32, dropout 0, ragged targets) at meshes (1,1,2), (2,1,2) and
  (1,2,2), and at (1,1,4) with 4 heads in the encoder and the decoder (one
  a rank; the 262-entry vocabulary splits 66/66/66/64, so the last shard
  is short): every loss and parameter within 1e-5 of the one-process
  port, the losses within 2e-4 of the JAX step on a mesh of the same
  shape; LAMB and the adaptive clip at (1,1,2); ``cruller_swin_test``
  (Swin encoder, relative-position table split on heads) at (1,1,2);
- the other train tasks at (1,1,2), 3 steps within 1e-5 of the
  one-process port: ``pix2struct_pretrain`` at ``pix2struct_test`` (ragged
  real patches and targets; the patch, row and column embeddings whole)
  and ``cruller_finetune_xent`` at ``cruller_test`` (the classifier: no
  decoder, ``final_fc`` whole), both from the JAX task's initial weights
  at a (1,1,2) mesh and within 2e-4 of its losses; the CORD, DocVQA and
  RVL-CDIP finetunes;
- the train log counts each sample of a step once (the ranks of a model
  group read the same batch);
- checkpoints: saved at (1,1,2), resumed in one process; saved in one
  process, resumed at (1,1,2); parameters and moments equal;
- dropout: the ranks of a model group draw the same stream, so a
  replicated activation (the decoder's output) is equal across the group,
  while the masks inside each rank's own FFN columns differ;
- ``kv_cache_dtype='int8'`` with ``model > 1`` raises the JAX error.

Each launch is waited for with a timeout; the file takes ~1-2 min on one
core.
"""

import contextlib
import dataclasses
import os
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import (  # noqa: E402
    GLOO_TIMEOUT_S,
    NO_DROPOUT,
    OPT,
    SCHED,
    STEPS,
    _jax_mesh_steps,
    global_batch,
    launch,
    rank_slice,
    run_steps,
    task_vocab,
)

PRETRAIN = "cruller_pretrain"
# case: (data, fsdp, model, model name, optimizer overrides, heads: None = the
# config's, task)
CASES = {
    "adamw_112": (1, 1, 2, "cruller_test", {}, None, PRETRAIN),
    "lamb_112": (1, 1, 2, "cruller_test", {"optimizer": "lamb"}, None, PRETRAIN),
    "agc_112": (1, 1, 2, "cruller_test", {"clip_grad_mode": "agc", "clip_grad_value": 0.01},
                None, PRETRAIN),
    "swin_112": (1, 1, 2, "cruller_swin_test", {}, None, PRETRAIN),
    "adamw_212": (2, 1, 2, "cruller_test", {}, None, PRETRAIN),
    "adamw_122": (1, 2, 2, "cruller_test", {}, None, PRETRAIN),
    "adamw_114": (1, 1, 4, "cruller_test", {}, 4, PRETRAIN),
    "p2s_112": (1, 1, 2, "pix2struct_test", {}, None, "pix2struct_pretrain"),
    "xent_112": (1, 1, 2, "cruller_test", {}, None, "cruller_finetune_xent"),
    "cord_112": (1, 1, 2, "cruller_test", {}, None, "cruller_finetune_cord"),
    "docvqa_112": (1, 1, 2, "cruller_test", {}, None, "cruller_finetune_docvqa"),
    "rvlcdip_112": (1, 1, 2, "cruller_test", {}, None, "cruller_finetune_rvlcdip"),
}
JAX_CASES = ("adamw_112", "adamw_212", "adamw_122", "adamw_114")
# the other tasks whose losses are held against the JAX task's at (1,1,2),
# from its initial weights
JAX_TASK_CASES = ("p2s_112", "xent_112")


def new_task(env, task_name=PRETRAIN, model_name="cruller_test", **opt):
    """The registered task ``task_name`` at a test size, fp32 (its train
    state not set up)."""
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cls, cfg_cls = TASK_CLASS_REGISTRY[task_name]
    cfg = cfg_cls(
        model_name=model_name, tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        dtype="float32", device="cpu", num_intervals=SCHED[0], num_warmup_intervals=SCHED[1],
        opt=OptimizationCfg(**{**OPT, **opt}),
    )
    return cls(cfg, env)


@contextlib.contextmanager
def initial_weights(task_name, init):
    """The model of ``task_name`` starts from ``init`` instead of its seeded
    init (pix2struct takes no resume checkpoint, the classifier's resume
    gives the encoder only)."""
    from pixparse_tpu_torch.models.interop import load_cruller_state_dict
    from pixparse_tpu_torch.models.pix2struct import Pix2StructCruller
    from pixparse_tpu_torch.task.task_cruller_finetune_xent import CrullerClassifier

    if task_name == "pix2struct_pretrain":
        cls, load = Pix2StructCruller, load_cruller_state_dict
    else:
        cls, load = CrullerClassifier, lambda m, sd: m.load_state_dict(sd, strict=True)
    seeded = cls.init_weights
    cls.init_weights = lambda self, generator: (load(self, init), self)[1]
    try:
        yield
    finally:
        cls.init_weights = seeded


def make_task(env, init, model_name="cruller_test", dropout=None, heads=None,
              task_name=PRETRAIN, **opt):
    """``task_name`` (default ``cruller_pretrain``) at a test size, fp32,
    from the weights ``init`` (a state dict; None: the seeded init), with
    ``heads`` attention heads in the encoder and the decoder (None: the
    config's), its train state set up."""
    task = new_task(env, task_name, model_name, **opt)
    drop = NO_DROPOUT if dropout is None else {k: dropout for k in NO_DROPOUT}
    task.bart_cfg = dataclasses.replace(task.bart_cfg, **drop)
    if heads is not None:
        task.vit_cfg = dataclasses.replace(task.vit_cfg, num_heads=heads)
        task.bart_cfg = dataclasses.replace(task.bart_cfg, decoder_attention_heads=heads)
    if task_name == PRETRAIN or init is None:
        task.resume_state_dict = None if init is None else dict(init)
        task.train_setup(num_batches_per_interval=SCHED[2], seed=0)
    else:
        with initial_weights(task_name, init):
            task.train_setup(num_batches_per_interval=SCHED[2], seed=0)
    return task


def _page(seed):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (80, 60), np.uint8), "L")


def raw_batch(task_name, task):
    """8 seeded rows as the task's loader hands them to ``train_step``:
    RVL-CDIP-like labels (the classifier), pages patchified at their own
    sizes with ragged targets (pix2struct), or the finetunes' collates."""
    from pixparse_tpu_torch.data.wds import default_collate

    rng = np.random.RandomState(5)
    if task_name == "cruller_finetune_xent":
        return {"image": rng.randn(8, 64, 48, 1).astype(np.float32),
                "label": rng.randint(0, 16, 8).astype(np.int32)}
    if task_name == "pix2struct_pretrain":
        L = task.max_position_embeddings
        samples = []
        for i in range(8):
            page = rng.randint(0, 255, (60 + 40 * i, 240 - 20 * i), np.uint8)
            txt = rng.randint(4, 200, (L,)).astype(np.int64)
            tgt = txt.copy()
            tgt[L - 1 - 2 * i:] = -100
            samples.append((task.image_preprocess_train(page), txt, tgt))
        return default_collate(samples)
    items = {
        "cruller_finetune_cord": lambda i: {"image": _page(i), "ground_truth": str({"gt_parse": {
            "menu": [{"nm": f"item {i}", "price": f"{i}.00"}], "total": {"total_price": str(i)}}})},
        "cruller_finetune_docvqa": lambda i: {"image": _page(i), "labels": [
            f"<s_question>q{i}?</s_question><s_answer>answer {i}</s_answer>"]},
        "cruller_finetune_rvlcdip": lambda i: {"image": _page(i), "label": i},
    }[task_name]
    np.random.seed(123)  # the DocVQA collate draws its question
    return task.collate_fn([items(i) for i in range(8)])


def case_batch(task, name, out_dir=None, seed=0):
    """``(batch for train_step, its normalized rows for the step function)``:
    for the pretrain cases ``global_batch``'s 8 rows (the JAX step's), the
    images redrawn at the task's size where it is not cruller_test's; for
    the other tasks ``raw_batch``'s, read from ``out_dir`` where the parent
    saved them."""
    task_name = CASES[name][6]
    if task_name != PRETRAIN:
        raw = torch.load(os.path.join(out_dir, f"batch_{name}.pt"), weights_only=False)
        return raw, task.normalize_batch(raw)
    batch = global_batch(task.vocab_size, seed=seed)
    h, w = task.vit_cfg.img_size
    if batch["image"].shape[1:3] != (h, w):
        batch["image"] = np.random.RandomState(seed + 1).randn(8, h, w, 1).astype(np.float32)
    return batch, batch


def whole_dump(state):
    """Every parameter and moment whole: gathered over ``(data, fsdp)`` and
    over ``model`` (a collective under a mesh)."""
    from pixparse_tpu_torch.parallel.mesh import is_sharded
    from pixparse_tpu_torch.parallel.tensor_parallel import gather_whole

    def whole(name, t):
        t = (t.full_tensor() if is_sharded(t) else t).detach().clone()
        if state.tp is not None and name in state.tp_layouts:
            t = gather_whole(t, state.tp_layouts[name], state.tp)
        return t

    out = {"params": {k: whole(k, v) for k, v in state.params.items()}, "step": state.step,
           "count": int(state.opt_state["count"])}
    for moment in ("mu", "nu"):
        out[moment] = {k: whole(k, v) for k, v in state.opt_state[moment].items()}
    return out


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _save(out_dir, name, obj):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out_dir, f"{name}.pt"))


def _case(out_dir, name, init, checkpoint=None):
    """Run case ``name``, save its record (and, at ``checkpoint``, its
    state after the steps)."""
    from pixparse_tpu_torch.framework.checkpoint import save_checkpoint
    from pixparse_tpu_torch.parallel.mesh import MeshEnv, data_parallel_rank

    data, fsdp, model, model_name, opt, heads, task_name = CASES[name]
    env = MeshEnv.initialize(data=data, fsdp=fsdp, model=model, device="cpu")
    task = make_task(env, case_init(name, init, out_dir), model_name, heads=heads,
                     task_name=task_name, **opt)
    dp = data * fsdp
    raw, batch = case_batch(task, name, out_dir)
    if dp > 1:
        raw = batch = rank_slice(batch, data_parallel_rank(env.mesh), dp)
    losses, norms = run_steps(task, batch)
    every = env.all_gather_object((losses, norms))
    assert all(e == every[0] for e in every), every  # the same metrics on every rank
    split = sorted(task.state.tp_layouts)
    dump = whole_dump(task.state)
    if checkpoint is not None:
        save_checkpoint(os.path.join(out_dir, checkpoint), task.state,
                        metadata={"interval": 0, "step": task.state.step})
    # one more step through the task's own train_step: the samples the
    # train log counts for it
    task.train_interval_start()
    task.train_step(raw)
    _save(out_dir, name, {"losses": losses, "norms": norms, "split": split, "env": str(env),
                          "data_ranks": env.all_gather_object((env.data_rank, env.data_size)),
                          "samples_logged": task._samples_since_log, **dump})
    return env, task


def case_init(name, init, out_dir):
    """A case's initial weights: the JAX init for the pretrain cases at
    ``cruller_test`` and for ``JAX_TASK_CASES`` (saved by the parent),
    else None (the seeded init)."""
    if name in JAX_TASK_CASES:
        return torch.load(os.path.join(out_dir, f"init_{name}.pt"))
    return init if CASES[name][6] == PRETRAIN and CASES[name][3] == "cruller_test" else None


def _worker(mode, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", timeout=timedelta(seconds=GLOO_TIMEOUT_S))
    rank = dist.get_rank()
    torch.set_num_threads(2)
    init = torch.load(os.path.join(out_dir, "init.pt"))
    if mode == "tp2":
        _tp2(out_dir, init)
    else:
        for name in ("adamw_212", "adamw_122", "adamw_114"):
            _case(out_dir, name, init)
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def _tp2(out_dir, init):
    """World 2: the (1,1,2) cases, the checkpoints both ways, dropout across
    the model group, the int8 refusal."""
    import torch.distributed as dist

    from pixparse_tpu_torch.framework.checkpoint import restore_train_state

    for name in ("lamb_112", "agc_112", "swin_112", "p2s_112", "xent_112", "cord_112",
                 "docvqa_112", "rvlcdip_112"):
        _case(out_dir, name, init)
    env, task = _case(out_dir, "adamw_112", init, checkpoint="ckpt_112")

    fresh = make_task(env, init)
    state, meta = restore_train_state(os.path.join(out_dir, "ckpt_alone"), fresh.state)
    _save(out_dir, "resume_alone_at_112", {"meta": meta, **whole_dump(state)})

    # dropout 0.5: the seeds the step draws, a train-mode forward from the
    # first one (each dropout's mask, by the stream it drew from), and the
    # replicated parameters after two steps, rank by rank
    import pixparse_tpu_torch.framework.train_state as train_state
    import pixparse_tpu_torch.models.bart as bart

    seeds, drawn = [], train_state.dropout_seed

    def recording(*args):
        seeds.append((args, drawn(*args)))
        return seeds[-1][1]

    task = make_task(env, init, dropout=0.5)
    batch = task._to_device(case_batch(task, "adamw_112")[1])
    train_state.dropout_seed = recording
    try:
        for _ in range(2):
            task.state, _ = task.train_step_fn(task.state, batch)
    finally:
        train_state.dropout_seed = drawn
    decoder = task.model.decoder
    decoder.reseed_dropout(seeds[0][1])
    masks, plain_dropout = {"replicated": [], "shard": []}, bart.dropout

    def mask_recording(x, rate, training, generator=None):
        out = plain_dropout(x, rate, training, generator)
        if training and rate:
            shard = generator is decoder.shard_dropout_generator
            masks["shard" if shard else "replicated"].append(out.detach() == 0)
        return out

    bart.dropout = mask_recording
    try:
        hidden, _, shard = task.model.forward_hidden_head(task.device_images(batch["image"]),
                                                          batch["text"])
    finally:
        bart.dropout = plain_dropout
    replicated = {k: v.full_tensor().detach() for k, v in task.state.params.items()
                  if k not in task.state.tp_layouts}
    _save(out_dir, "dropout", {"seeds": env.all_gather_object(seeds),
                               "hidden": env.all_gather_object(hidden.detach()),
                               "masks": env.all_gather_object(masks),
                               "replicated": env.all_gather_object(replicated),
                               "offsets": env.all_gather_object(shard[1])})
    del task

    from pixparse_tpu_torch.task.task_cruller_eval_ocr import (
        TaskCrullerEvalOCR,
        TaskCrullerEvalOCRCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    try:
        TaskCrullerEvalOCR(TaskCrullerEvalOCRCfg(
            model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
            device="cpu", kv_cache_dtype="int8"), env)
        raised = ""
    except ValueError as e:
        raised = str(e)
    _save(out_dir, "int8", {"raised": raised})
    dist.barrier()


# --------------------------------------------------------------------------
# the references and the runs, made once
# --------------------------------------------------------------------------

def _jax_init(vocab, shape, heads=None):
    """The JAX model (``heads`` attention heads in the encoder and the
    decoder; None: the config's), a mesh of ``shape`` over the first
    virtual devices, its train state, and the initial weights in the
    port's names."""
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
    if heads is not None:
        jv = dataclasses.replace(jv, num_heads=heads)
        jb = dataclasses.replace(jb, decoder_attention_heads=heads)
    model = JaxCruller(jv, jb, attn_impl="xla")
    mesh = jax_create_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])
    depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
    tx, _ = jax_create_optimizer(JaxOptCfg(**OPT), *SCHED, **depth, wrap_multisteps=False)
    example = (jnp.zeros((8, 64, 48, 1)), jnp.zeros((8, 16), jnp.int32))
    state, _ = jax_create_train_state(model, tx, mesh, example, seed=0)
    init = cruller_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params), jv, jb)
    return (model, mesh, state, jv, jb), init


def _jax_task_steps(name, out_dir):
    """The JAX task of ``name`` at its (1,1,2) mesh of 2 virtual devices
    (fp32, dropout 0, seed 0): its initial weights in the port's names and
    the losses of 3 steps on the batch the parent saved."""
    import jax

    from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
    from pixparse_tpu.parallel.mesh import MeshEnv as JaxMeshEnv
    from pixparse_tpu.task import TASK_CLASS_REGISTRY as JAX_REGISTRY
    from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg
    from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax

    data, fsdp, model, model_name, _, _, task_name = CASES[name]
    cls, cfg_cls = JAX_REGISTRY[task_name]
    env = JaxMeshEnv.initialize(data, fsdp, model, devices=jax.devices()[:data * fsdp * model])
    task = cls(cfg_cls(model_name=model_name, tokenizer=JaxTokCfg(name="pixparse_bytelevel"),
                       num_intervals=SCHED[0], num_warmup_intervals=SCHED[1],
                       opt=JaxOptCfg(**OPT)), env, None)
    task.bart_cfg = dataclasses.replace(task.bart_cfg, **NO_DROPOUT)
    task.train_setup(num_batches_per_interval=SCHED[2], seed=0)
    if task_name == "pix2struct_pretrain":
        from pixparse_tpu_torch.device import DeviceEnv

        # the port's cfgs of the same model
        port = new_task(DeviceEnv(torch.device("cpu")), task_name, model_name)
        params = jax.tree_util.tree_map(np.asarray, task.state.params)
        init = cruller_state_dict_from_jax(params, port.vit_cfg, port.bart_cfg)
    else:
        init = {k: torch.from_numpy(np.array(v)) for k, v in task.state_dict().items()}
    batch = task.normalize_batch(torch.load(os.path.join(out_dir, f"batch_{name}.pt"),
                                            weights_only=False))
    losses = []
    for _ in range(STEPS):
        task.state, m = task.train_step_fn(task.state, env.shard_batch(batch))
        losses.append(float(m["loss"]))
    return losses, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX inits and mesh steps, the one-process port runs, the world-2
    launch, then the world-4 launch."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import save_checkpoint

    out = str(tmp_path_factory.mktemp("tp"))
    vocab = task_vocab()
    alone = DeviceEnv(torch.device("cpu"))
    for name, (_, _, _, model_name, _, _, task_name) in CASES.items():
        if task_name != PRETRAIN:
            torch.save(raw_batch(task_name, new_task(alone, task_name, model_name)),
                       os.path.join(out, f"batch_{name}.pt"))
    jax_losses, init = {}, None
    for name in JAX_CASES:
        jax_state, mesh_init = _jax_init(vocab, CASES[name][:3], CASES[name][5])
        init = mesh_init if init is None else init
        jax_losses[name] = _jax_mesh_steps(jax_state, vocab)[0]
    for name in JAX_TASK_CASES:
        jax_losses[name], task_init = _jax_task_steps(name, out)
        torch.save(task_init, os.path.join(out, f"init_{name}.pt"))
    torch.save(init, os.path.join(out, "init.pt"))

    refs = {}
    for name, (_, _, _, model_name, opt, heads, task_name) in CASES.items():
        key = (model_name, tuple(sorted(opt.items())), heads, task_name)
        if key not in refs:
            task = make_task(alone, case_init(name, init, out), model_name, heads=heads,
                             task_name=task_name, **opt)
            losses, norms = run_steps(task, case_batch(task, name, out)[1])
            refs[key] = {"losses": losses, "norms": norms, **whole_dump(task.state)}
            if key == ("cruller_test", (), None, PRETRAIN):
                save_checkpoint(os.path.join(out, "ckpt_alone"), task.state,
                                metadata={"interval": 0, "step": task.state.step})
        refs[name] = refs[key]

    outputs = launch(2, ["tp2", out], script=__file__)
    outputs += launch(4, ["tp4", out], script=__file__)
    return dict(out=out, refs=refs, jax=jax_losses, outputs=outputs, init=init)


def load(runs, name):
    return torch.load(os.path.join(runs["out"], f"{name}.pt"), weights_only=False)


def _close(got, want, atol, what, parts=("params", "mu", "nu")):
    for part in parts:
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), atol=atol,
                                       rtol=0 if part == "params" else 1e-4,
                                       err_msg=f"{what}: {part} {k}")


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_steps_equal_the_process_alone(runs, name):
    got, want = load(runs, name), runs["refs"][name]
    data, fsdp, model = CASES[name][:3]
    assert f"'model': {model}" in got["env"] and f"'data': {data}" in got["env"]
    # the ranks of a model group read the same data: rank r reads as r // model
    world = data * fsdp * model
    assert got["data_ranks"] == [(r // model, data * fsdp) for r in range(world)]
    # the train log counts the global batch's 8 samples once, not once a model rank
    assert got["samples_logged"] == 8
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=1e-5, rtol=1e-5)
    assert got["step"] == want["step"] == STEPS and got["count"] == want["count"] == STEPS
    _close(got, want, 1e-5, name)


def test_the_plan_splits_heads_mlp_and_vocabulary(runs):
    split = load(runs, "adamw_112")["split"]
    for suffix in ("blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias",
                   "blocks.0.attn.proj.weight", "blocks.0.mlp.fc1.weight",
                   "blocks.0.mlp.fc1.bias", "blocks.0.mlp.fc2.weight",
                   "layers.0.self_attn.q_proj.weight", "layers.0.encoder_attn.v_proj.bias",
                   "layers.0.self_attn.out_proj.weight", "layers.0.fc1.weight",
                   "layers.0.fc2.weight", "decoder.embed_tokens.weight", "lm_head.weight"):
        assert any(n.endswith(suffix) for n in split), suffix
    for suffix in ("attn.proj.bias", "fc2.bias", "norm1.weight", "embed_positions.weight",
                   "pos_embed", "patch_embed.proj.weight"):
        assert not any(n.endswith(suffix) for n in split), suffix
    swin = load(runs, "swin_112")["split"]
    assert any(n.endswith("relative_position_bias_table") for n in swin)
    assert not any(n.endswith("reduction.weight") for n in swin)


def test_the_plan_keeps_pix2struct_embeddings_and_the_classifier_head_whole(runs):
    p2s = load(runs, "p2s_112")
    assert {n for n in p2s["split"] if "image_encoder" in n} >= {
        "image_encoder.trunk.blocks.0.attn.qkv.weight", "image_encoder.trunk.blocks.1.mlp.fc2.weight"}
    for name in ("patch_embed.weight", "patch_embed.bias", "row_embed.weight", "col_embed.weight"):
        assert "image_encoder.trunk." + name in p2s["params"]
        assert not any(n.endswith(name) for n in p2s["split"]), name
    xent = load(runs, "xent_112")
    assert set(xent["params"]) >= {"final_fc.weight", "final_fc.bias"}
    assert "encoder.trunk.blocks.0.attn.qkv.weight" in xent["split"]
    assert not any(n.startswith("final_fc") or "patch_embed" in n for n in xent["split"])


@pytest.mark.parametrize("name", JAX_CASES + JAX_TASK_CASES)
def test_tensor_parallel_losses_follow_the_jax_mesh_step(runs, name):
    np.testing.assert_allclose(load(runs, name)["losses"], runs["jax"][name], atol=2e-4, rtol=0)


def _equal_states(got, want, what):
    for part in ("params", "mu", "nu"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), f"{what}: {part} {k}"
    assert got["step"] == want["step"] and got["count"] == want["count"]


def test_a_tensor_parallel_checkpoint_resumes_in_one_process(runs):
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state

    saved = load(runs, "adamw_112")
    names = os.listdir(os.path.join(runs["out"], "ckpt_112"))
    assert "metadata.json" in names and ".metadata" in names
    task = make_task(DeviceEnv(torch.device("cpu")), runs["init"])
    state, meta = restore_train_state(os.path.join(runs["out"], "ckpt_112"), task.state)
    assert meta == {"interval": 0, "step": STEPS}
    _equal_states(whole_dump(state), saved, "(1,1,2) -> one process")


def test_a_one_process_checkpoint_resumes_at_model_two(runs):
    got = load(runs, "resume_alone_at_112")
    assert got["meta"] == {"interval": 0, "step": STEPS}
    _equal_states(got, runs["refs"]["adamw_112"], "one process -> (1,1,2)")


def test_dropout_is_equal_across_a_model_group(runs):
    from pixparse_tpu_torch.framework.train_state import dropout_seed

    rec = load(runs, "dropout")
    s0, s1 = rec["seeds"]
    assert len(s0) == 2 and s0 == s1  # one stream a step, the same on both model ranks
    for step, (args, seed) in enumerate(s0):
        assert args[1] == step and args[-1] == 0 and seed == dropout_seed(*args)
    h0, h1 = rec["hidden"]
    assert torch.equal(h0, h1)  # the replicated output: the same masks on both ranks
    m0, m1 = rec["masks"]
    assert len(m0["replicated"]) == len(m1["replicated"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(m0["replicated"], m1["replicated"]))
    # the activation dropout inside each rank's own FFN columns: one mask a
    # layer, different on the two ranks (a mask over the whole tensor)
    assert len(m0["shard"]) == len(m1["shard"]) == 2
    for a, b in zip(m0["shard"], m1["shard"]):
        assert a.shape == b.shape and not torch.equal(a, b)
        assert 0.4 < a.float().mean() < 0.6 and 0.4 < b.float().mean() < 0.6
    r0, r1 = rec["replicated"]
    assert r0.keys() == r1.keys() and all(torch.equal(r0[k], r1[k]) for k in r0)
    assert rec["offsets"] == [0, runs["refs"]["adamw_112"]["params"][
        "text_decoder.trunk.model.decoder.embed_tokens.weight"].shape[0] // 2]


def test_int8_caches_refuse_a_model_axis(runs):
    assert "does not support a model-parallel" in load(runs, "int8")["raised"]


def test_train_app_at_model_two_writes_one_set_of_outputs(tmp_path):
    """``app.train --task.mesh.model 2`` at 2 ranks for 2 intervals: one
    experiment, a sharded checkpoint each interval, and the ``.pt`` holds
    the whole weights (the last checkpoint's, restored in one process)."""
    import json

    from test_torch_train_cli import _make_shard

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state

    d = str(tmp_path)
    _make_shard(os.path.join(d, "train.tar"), 16)
    out = os.path.join(d, "train")
    launch(2, [
        "pixparse_tpu_torch.app.train", "--train.task_name", "cruller_pretrain",
        "--train.output_dir", out, "--train.seed", "42", "--task.model_name", "cruller_test",
        "--task.tokenizer.name", "pixparse_bytelevel", "--task.num_intervals", "2",
        "--task.num_warmup_intervals", "1", "--task.opt.learning_rate", "1e-4",
        "--task.dtype", "float32", "--task.device", "cpu", "--task.mesh.model", "2",
        "--data.train.source", os.path.join(d, "train.tar"), "--data.train.num_samples", "8",
        "--data.train.batch_size", "4", "--data.train.split", "train",
        "--data.train.num_workers", "1",
    ], module=True)
    (experiment,) = os.listdir(out)
    ckpt_dir = os.path.join(out, experiment, "checkpoints", experiment)
    assert sorted(os.listdir(ckpt_dir)) == [
        "checkpoint-0", "checkpoint-0.pt", "checkpoint-1", "checkpoint-1.pt"]
    with open(os.path.join(ckpt_dir, "checkpoint-1", "metadata.json")) as fh:
        assert json.load(fh) == {"interval": 1, "step": 4}
    with open(os.path.join(out, experiment, "out.log")) as fh:
        assert "mesh=MeshCfg(data=0, fsdp=1, model=2)" in fh.read()
    weights = torch.load(os.path.join(ckpt_dir, "checkpoint-1.pt"), weights_only=True)
    task = make_task(DeviceEnv(torch.device("cpu")), weights)
    state, meta = restore_train_state(os.path.join(ckpt_dir, "checkpoint-1"), task.state)
    assert meta == {"interval": 1, "step": 4} and state.step == 4
    for k, v in state.params.items():
        assert torch.equal(v.detach(), weights[k]), k


def test_chip_smoke_tensor_parallel_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``tensor_parallel`` phase, its part (b), on the CPU
    at cruller_test and pix2struct_test: the torchrun child's two gloo ranks
    train both at (1,1,2) beside rank 0 alone and decode through the eval
    task, and pass their own checks (step-1 loss, the same losses on both
    ranks, launches a step equal; the same tokens on both ranks, logits
    within the cached-decode gate of alone's)."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(cs, "TP_CHILD_TIMEOUT_S", 150)  # a hang fails here (it takes ~20 s)
    os.makedirs(cs.OUT_DIR)
    counts = cs.phase_tensor_parallel(torch, model_name="cruller_test", B=2, steps=3, vocab=300,
                                      device="cpu", decode_B=2, p2s_model="pix2struct_test",
                                      p2s_B=2)
    assert not any(counts["tensor_parallel"].values())  # no kernel on the CPU
    rec = json.loads((tmp_path / "out" / "phases.jsonl").read_text().splitlines()[-1])
    child = rec["two_rank_step"]
    assert rec["phase"] == "tensor_parallel" and rec["problems"] == []
    assert child["backend"] == "gloo" and child["world_size"] == 2 and "'model': 2" in child["env"]
    assert child["runs"]["model_parallel"]["split_params"] > 0
    assert child["step1"]["loss_rel"] <= 1e-3
    assert child["pix2struct"]["runs"]["model_parallel"]["split_params"] > 0
    assert child["pix2struct"]["step1"]["loss_rel"] <= 1e-3
    decode = child["decode"]
    assert decode["tokens_equal_across_ranks"] and decode["steps"] == 31
    assert decode["model_parallel"]["split_params"] > 0
    assert decode["teacher_forced_max_abs_err"] <= 5e-2


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
