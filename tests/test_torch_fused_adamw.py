"""The fused AdamW update (``ops/optimizer.py``, ``csrc/fused_adamw.cu``)
against the optimizer chain (``framework/optimization.py``).

This file imports torch and the port only (no JAX), so its card tests run on
a CUDA machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_adamw.py

The unmarked tests run anywhere: which path the train step takes, the
per-leaf tables at cruller_base's and donut_base's parameter names, the
``optimizer.fused`` counter, and that the kernels' plan takes CUDA tensors
only (the CPU keeps the chain). The ``cuda``-marked tests hold the kernels
against the chain on the card and skip without one.

Tolerances. The kernels and the chain compute the same fp32 operations in
the same order; the chain's ``add`` with ``alpha`` may contract into a
fused multiply-add on the card, and the norm sums in another order, so
moments agree to 1e-5 relative (a few ulps over three steps) plus 1e-6 of
the leaf's largest moment (where ``b1 m`` and ``(1 - b1) g`` nearly
cancel, those ulps are of the terms, not of the sum), parameters to 1e-6
relative plus 1e-9 (each side rounds ``p + u`` once). With bf16 moments one
side's moment may round one bf16 ulp (2^-8) away from the other's: moments
then agree to 2^-7 relative plus 2^-8 of the leaf's largest moment (the
next step carries the flip's absolute size into a sum that may nearly
cancel), and a flipped moment moves the next update by up to ~0.4% of
``lr``, so parameters get 1e-5 absolute at ``lr`` <= 1e-3. The norm: 1e-5
relative (order of the sum).
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import pytest
import torch

from pixparse_tpu_torch.framework import profiling
from pixparse_tpu_torch.framework import train_state as ts
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.optimization import (
    create_optimizer,
    default_weight_decay_mask,
    fused_update_applies,
    layer_decay_scales,
)
from pixparse_tpu_torch.ops.optimizer import (
    FUSED_ADAMW_CHUNK,
    FUSED_ADAMW_MAX_LEAVES,
    FusedAdamWPlan,
    chunk_table,
    fused_adamw,
)

SCHED = dict(num_intervals=10, num_warmup_intervals=1, updates_per_interval=2)
DEPTHS = {"cruller_base": (12, 4), "donut_base": (20, 4)}
VOCABS = {"cruller_base": 50265, "donut_base": 57525}
# leaves past the models' own: one element, ragged, a chunk and one more,
# exactly two chunks, and (the flag) one 4 bytes off a 16-byte boundary
EXTRA = [((1,), False), ((3, 5), False), ((FUSED_ADAMW_CHUNK + 1,), False),
         ((2, FUSED_ADAMW_CHUNK), False), ((7, 9), True), ((1,), True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _optimizer(model_name="cruller_base", **cfg):
    enc, dec = DEPTHS[model_name]
    opt, _ = create_optimizer(OptimizationCfg(**cfg), **SCHED, encoder_depth=enc,
                              decoder_layers=dec)
    return opt


@functools.lru_cache(maxsize=None)
def _model_leaves(model_name: str) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(name, shape) of every parameter of the model at full width, built on
    the meta device (no memory)."""
    from pixparse_tpu_torch.models import get_model_config, resolve_cruller_cfgs
    from pixparse_tpu_torch.models.cruller import create_cruller

    vit, bart, _ = resolve_cruller_cfgs(get_model_config(model_name),
                                        vocab_size=VOCABS[model_name])
    with torch.device("meta"):
        model = create_cruller(vit, bart)
    return tuple((n, tuple(p.shape)) for n, p in model.named_parameters())


# --------------------------------------------------------------------------
# which path, the tables, the counter (anywhere)
# --------------------------------------------------------------------------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("cfg,device,sharded,want", [
    (dict(optimizer="adamw"), CUDA, False, True),
    (dict(optimizer="adam"), CUDA, False, True),
    (dict(optimizer="adamw", clip_grad_value=1.0), CUDA, False, True),  # mode norm by default
    (dict(optimizer="adamw", clip_grad_value=1.0, clip_grad_mode="norm", layer_decay=0.75,
          optimizer_state_dtype="bfloat16"), CUDA, False, True),
    (dict(optimizer="adamw"), CPU, False, False),
    (dict(optimizer="adamw"), CUDA, True, False),
    (dict(optimizer="lamb"), CUDA, False, False),
    (dict(optimizer="sgd"), CUDA, False, False),
    (dict(optimizer="momentum"), CUDA, False, False),
    (dict(optimizer="adamw", clip_grad_value=1.0, clip_grad_mode="agc"), CUDA, False, False),
    (dict(optimizer="adamw", clip_grad_value=1.0, clip_grad_mode="value"), CUDA, False, False),
])
def test_fused_update_applies(cfg, device, sharded, want):
    shards = object() if sharded else None
    assert fused_update_applies(_optimizer(**cfg), device, shards) is want


def _tiny_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.LayerNorm(7),
                               torch.nn.Linear(7, 1))


def _steps(opt, model, n=3):
    state = ts.create_train_state(model, opt)
    step = ts.make_train_step(lambda b: ((model(b) ** 2).mean(), {}), opt)
    gen = torch.Generator().manual_seed(1)
    metrics = []
    for _ in range(n):
        state, m = step(state, torch.randn(4, 5, generator=gen))
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("cfg", [
    dict(optimizer="adamw"),
    dict(optimizer="lamb"),
    dict(optimizer="sgd"),
    dict(optimizer="adamw", clip_grad_value=0.5, clip_grad_mode="agc"),
    dict(optimizer="adamw", clip_grad_value=0.5, clip_grad_mode="value"),
])
def test_cpu_train_step_takes_the_chain(cfg, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the fused update ran on the CPU")

    monkeypatch.setattr(type(_optimizer()), "fused_update", refuse)
    launches = fused_adamw.launches
    with profiling.collect() as seen:
        state, metrics = _steps(_optimizer(**cfg), _tiny_model())
    assert "optimizer.fused" not in seen.counts
    assert fused_adamw.launches == launches
    assert state.step == 3 and all(int(m["nonfinite"]) == 0 for m in metrics)


@pytest.mark.parametrize("model_name", ["cruller_base", "donut_base"])
@pytest.mark.parametrize("layer_decay", [None, 0.75])
def test_tables_once_equal_the_chain_builders(model_name, layer_decay):
    """The decay flags and scales the plan is built from, once, over the
    model's full-width leaves (meta tensors), equal the chain's per-step
    builders; the kernels' chunks cover every leaf once."""
    leaves = _model_leaves(model_name)
    with torch.device("meta"):
        params = {n: torch.empty(s) for n, s in leaves}
    enc, dec = DEPTHS[model_name]
    opt = _optimizer(model_name, optimizer="adamw", weight_decay=0.02, layer_decay=layer_decay)
    decay, scales = opt.fused_tables(params)
    mask = default_weight_decay_mask(params)
    assert decay == [mask[n] for n in params]
    if layer_decay is None:
        assert scales == [1.0] * len(params)
    else:
        by_name = layer_decay_scales(params, layer_decay, enc, dec)
        assert scales == [by_name[n] for n in params]
        assert len(set(scales)) > enc // 4  # depths spread over the leaves
    assert any(decay) and not all(decay)
    # the kernels' blocks: every leaf covered once, in chunks the kernel takes
    sizes = [p.numel() for p in params.values()]
    chunks = chunk_table(sizes)
    assert len(sizes) <= FUSED_ADAMW_MAX_LEAVES
    assert 0 < chunks["len"].min() and chunks["len"].max() <= FUSED_ADAMW_CHUNK
    for i, n in enumerate(sizes):
        mine = chunks[chunks["leaf"] == i]
        assert mine["off"].tolist() == list(range(0, n, FUSED_ADAMW_CHUNK))
        assert int(mine["len"].sum()) == n


def test_adam_tables_decay_nothing():
    params = {n: torch.empty(s, device="meta") for n, s in _model_leaves("cruller_base")}
    flags, scales = _optimizer(optimizer="adam", weight_decay=0.02).fused_tables(params)
    assert not any(flags) and scales == [1.0] * len(params)


def test_plan_refuses_leaves_off_the_card():
    """The kernels have no CPU mode: a plan of CPU tensors, and so a fused
    update of them, raise instead of running anything."""
    params = dict(_tiny_model().named_parameters())
    opt = _optimizer(optimizer="adamw")
    state = opt.init(params)
    p = list(params.values())
    with pytest.raises(ValueError, match="CUDA"):
        FusedAdamWPlan(list(params), p, list(state["mu"].values()),
                       list(state["nu"].values()), *opt.fused_tables(params))
    launches = fused_adamw.launches
    with pytest.raises(ValueError, match="CUDA"), torch.no_grad():
        opt.fused_update(params, [torch.ones_like(x) for x in p], state, torch.zeros(()))
    assert fused_adamw.launches == launches and opt._fused_plan is None


def test_init_drops_the_plan():
    """A new state drops the plan of the old one, which holds its tensors."""
    opt = _optimizer(optimizer="adamw")
    opt._fused_plan = object()  # stands for a plan over an earlier state
    opt.init(dict(_tiny_model().named_parameters()))
    assert opt._fused_plan is None


def test_fused_step_counts_one(monkeypatch):
    """Where the fused update applies (forced here on the CPU, with the
    update itself stood in for: its kernels run only on the card), each
    step counts one ``optimizer.fused`` and returns the update's metrics and
    the state it was given."""
    calls = []

    def fused_update(self, params, grads, state, loss, skip_nonfinite=True):
        calls.append((state, len(grads), skip_nonfinite))
        return dict(loss=loss, grad_norm=torch.zeros(()), nonfinite=torch.zeros((), dtype=torch.int32))

    monkeypatch.setattr(ts, "fused_update_applies", lambda *args, **kwargs: True)
    opt = _optimizer(optimizer="adamw")
    monkeypatch.setattr(type(opt), "fused_update", fused_update)
    with profiling.collect() as seen:
        state, metrics = _steps(opt, _tiny_model())
    assert seen.counts == {"optimizer.fused": 3}
    assert [c[1:] for c in calls] == [(6, True)] * 3
    assert all(c[0] is state.opt_state for c in calls)  # the state kept, not rebuilt
    assert state.step == 3
    assert [sorted(m) for m in metrics] == [["grad_norm", "loss", "nonfinite"]] * 3


def test_chip_smoke_counts_the_fused_update_and_holds_it_to_the_chain(monkeypatch):
    """chip_smoke.py counts the fused update's launches in its one-device
    train phases, carries it on the kernels line, and runs the plain side
    of its kernel-vs-plain steps through the chain."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.read_counts()["fused_adamw"] == fused_adamw.launches
    assert all("fused_adamw" in kernels for kernels in cs.TRAIN_KERNELS.values())
    assert "fused_adamw" in cs.PRETRAINED_KERNELS and cs.ADAMW_STEP == 2
    assert cs.FINETUNE_TASK_KERNELS["finetune_cord"](12, 4, 3, 0)["fused_adamw"] == 6
    assert "fused_adamw" in [k[0] for k in cs.KERNELS]
    forced = lambda *args, **kwargs: True
    monkeypatch.setattr(ts, "fused_update_applies", forced)  # the CPU would raise
    with cs.chain_update():
        state, metrics = _steps(_optimizer(optimizer="adamw"), _tiny_model())
    assert ts.fused_update_applies is forced
    assert state.step == 3 and int(state.opt_state["count"]) == 3


# --------------------------------------------------------------------------
# the kernels against the chain, on the card
# --------------------------------------------------------------------------

def _leaf_specs(model_name=None):
    """(name, shape, misaligned) of the leaves of a test: the model's (or a
    small cruller-like set) and EXTRA."""
    if model_name is None:
        base = [("image_encoder.trunk.patch_embed.proj.weight", (16, 1, 4, 4)),
                ("image_encoder.trunk.pos_embed", (1, 5, 16)),
                ("image_encoder.trunk.blocks.0.attn.qkv.weight", (48, 16)),
                ("image_encoder.trunk.blocks.0.attn.qkv.bias", (48,)),
                ("image_encoder.trunk.blocks.0.norm1.weight", (16,)),
                ("text_decoder.model.decoder.layers.0.fc1.weight", (33, 16)),
                ("text_decoder.model.decoder.embed_tokens.weight", (37, 16))]
    else:
        base = list(_model_leaves(model_name))
    extra = [(f"text_decoder.extra.{i}.weight", s, mis) for i, (s, mis) in enumerate(EXTRA)]
    return [(n, s, False) for n, s in base] + extra


def _make_params(specs, device, seed) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, shape, misaligned in specs:
        n = 1
        for d in shape:
            n *= d
        x = torch.randn(n, generator=gen, device=device) * 0.5
        if misaligned:  # a contiguous view 4 bytes past an aligned start
            buf = torch.empty(n + 1, device=device)
            buf[1:].copy_(x)
            x = buf[1:]
        params[name] = x.view(shape)
    return params


def _grads(params, device, seed, scale) -> List[List[torch.Tensor]]:
    gen = torch.Generator(device=device).manual_seed(seed)
    return [[torch.randn(p.shape, generator=gen, device=device) * s for p in params.values()]
            for s in scale]


def _copy(params):
    return {n: p.detach().clone() for n, p in params.items()}


def _run(opt, params, grads, losses, fused, monkeypatch):
    """Steps of ``_apply_update`` over ``params`` (changed in place):
    ``(opt_state, metrics per step)``, through the chain unless ``fused``."""
    with monkeypatch.context() as mp:
        if fused is not None:
            mp.setattr(ts, "fused_update_applies", lambda *a, **k: fused)
        state = opt.init(params)
        metrics = []
        with torch.no_grad():
            for g, loss in zip(grads, losses):
                state, m = ts._apply_update(opt, params, [x.clone() for x in g], state, loss,
                                            True)
                metrics.append(m)
    return state, metrics


def _assert_same_step(params_a, state_a, metrics_a, params_b, state_b, metrics_b, bf16):
    for a, b in zip(metrics_a, metrics_b):
        torch.testing.assert_close(a["grad_norm"], b["grad_norm"], rtol=1e-5, atol=0)
        assert int(a["nonfinite"]) == int(b["nonfinite"])
    assert int(state_a["count"]) == int(state_b["count"])
    ptol = dict(rtol=1e-6, atol=1e-5 if bf16 else 1e-9)
    mrtol, matol = (2.0 ** -7, 2.0 ** -8) if bf16 else (1e-5, 1e-6)
    for n in params_a:
        torch.testing.assert_close(params_a[n], params_b[n], **ptol, msg=lambda m: f"{n}: {m}")
        for k in ("mu", "nu"):
            ref = state_b[k][n].float()
            torch.testing.assert_close(state_a[k][n].float(), ref, rtol=mrtol,
                                       atol=matol * float(ref.abs().max()),
                                       msg=lambda m: f"{k} {n}: {m}")


OPT_CASES = [
    dict(optimizer="adamw", learning_rate=1e-3, warmup_learning_rate=1e-4, weight_decay=0.02,
         eps=1e-6),  # the pretrain cells' settings
    dict(optimizer="adamw", learning_rate=1e-3, warmup_learning_rate=1e-4, weight_decay=0.05,
         clip_grad_value=1.0, layer_decay=0.75, optimizer_state_dtype="bfloat16"),
    dict(optimizer="adam", learning_rate=5e-4, warmup_learning_rate=5e-4, betas=(0.8, 0.95),
         clip_grad_value=1e3),  # a clip that stays below its threshold
]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", OPT_CASES)
def test_kernels_match_the_chain_on_cruller_base_leaves(cuda_device, cfg, monkeypatch):
    """Three steps over cruller_base's 258 leaves and EXTRA's ragged, one-
    element and misaligned ones, the kernels against the chain; a second run
    of the kernels repeats the first bit for bit; two launches a step."""
    specs = _leaf_specs("cruller_base")
    params = _make_params(specs, cuda_device, 0)
    scales = (0.01, 0.04, 0.002)
    grads = _grads(params, cuda_device, 1, scales)
    losses = [torch.tensor(2.5, device=cuda_device)] * 3
    bf16 = cfg.get("optimizer_state_dtype") == "bfloat16"
    pa, pb, pc = _copy(params), _copy(params), _copy(params)
    del params
    sa, ma = _run(_optimizer(**cfg), pa, grads, losses, False, monkeypatch)
    launches = fused_adamw.launches
    with profiling.collect() as seen:
        sb, mb = _run(_optimizer(**cfg), pb, grads, losses, None, monkeypatch)
    torch.cuda.synchronize()
    assert fused_adamw.launches - launches == 2 * len(grads)
    assert seen.counts == {"optimizer.fused": len(grads)}
    _assert_same_step(pb, sb, mb, pa, sa, ma, bf16)
    if cfg.get("clip_grad_value") == 1.0:  # the clip engaged (1e3 stays below the norm)
        assert float(ma[0]["grad_norm"]) > cfg["clip_grad_value"]
    sc, mc = _run(_optimizer(**cfg), pc, grads, losses, None, monkeypatch)
    assert all(torch.equal(b["grad_norm"], c["grad_norm"]) for b, c in zip(mb, mc))
    assert all(torch.equal(pb[n], pc[n]) for n in pb)
    assert all(torch.equal(sb[k][n], sc[k][n]) for k in ("mu", "nu") for n in pb)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["loss", "grad"])
def test_kernels_skip_a_nonfinite_step_bit_identical(cuda_device, bad, monkeypatch):
    params = _make_params(_leaf_specs("cruller_base"), cuda_device, 0)
    grads = _grads(params, cuda_device, 1, (0.01, 0.01))
    losses = [torch.tensor(2.5, device=cuda_device)] * 2
    if bad == "loss":
        losses[1] = torch.tensor(float("nan"), device=cuda_device)
    else:
        grads[1][100].view(-1)[7] = float("inf")
    opt = _optimizer(optimizer="adamw", learning_rate=1e-3, warmup_learning_rate=1e-3,
                     clip_grad_value=1.0)
    state, _ = _run(opt, params, grads[:1], losses[:1], None, monkeypatch)
    before = (_copy(params), _copy(state["mu"]), _copy(state["nu"]), state["count"].clone())
    launches = fused_adamw.launches
    with torch.no_grad():
        state2, m = ts._apply_update(opt, params, grads[1], state, losses[1], True)
    torch.cuda.synchronize()
    assert fused_adamw.launches - launches == 2 and state2 is state
    assert int(m["nonfinite"]) == 1
    assert bool(torch.isfinite(m["grad_norm"])) == (bad == "loss")
    for now, then in zip((params, state["mu"], state["nu"]), before[:3]):
        assert all(torch.equal(now[n], then[n]) for n in now)
    assert torch.equal(state["count"], before[3])


@pytest.mark.cuda
def test_new_leaves_get_a_new_plan(cuda_device):
    """The plan serves while the leaves stay where they are: a replaced
    moment gets a new plan over it, and a new state drops the old plan."""
    params = _make_params(_leaf_specs(), cuda_device, 0)
    opt = _optimizer(optimizer="adamw")
    state = opt.init(params)
    grads = [torch.ones_like(p) for p in params.values()]
    loss = torch.zeros((), device=cuda_device)
    name = next(iter(params))
    with torch.no_grad():
        opt.fused_update(params, grads, state, loss)
        plan = opt._fused_plan
        opt.fused_update(params, grads, state, loss)
        assert opt._fused_plan is plan
        state["mu"][name] = state["mu"][name].clone()  # a replaced tensor
        opt.fused_update(params, grads, state, loss)
    assert opt._fused_plan is not plan
    assert opt._fused_plan.mu[0] is state["mu"][name]
    assert int(state["count"]) == 3
    opt.init(params)
    assert opt._fused_plan is None
