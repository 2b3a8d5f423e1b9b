"""``cruller_moonlight`` (``models/moonlight.py``, ``ops/moe.py``) on the CPU
at the ``cruller_moonlight_test`` size, against the plain float32 reference
of ``tests/plain_moonlight.py`` on the same seeded weights.

Tolerances, all fp32 on both sides, so what is left is summation order:

- logits and loss: ``atol 2e-6`` / ``rtol 1e-5`` (the port and the plain
  reference agree to ~2e-7 at this size; bf16 products in the reference
  move the logits by ~1e-3, which fails them);
- every leaf's gradient: ``atol 1e-6 + rtol 1e-4`` of the leaf's largest
  entry (the backward runs other kernels and sums in other orders than
  autograd through the plain loop over experts).

The reference takes the port's expert choice where the two could differ
(``follow``); every test also checks that the choice is the reference's own
wherever its k-th and (k+1)-th scores are more than ``1e-5`` apart.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_moonlight as plain  # noqa: E402
from pixparse_tpu_torch.framework.optimization import default_weight_decay_mask  # noqa: E402
from pixparse_tpu_torch.framework.profiling import collect  # noqa: E402
from pixparse_tpu_torch.models.config import get_model_config  # noqa: E402
from pixparse_tpu_torch.models.cruller import create_cruller, resolve_cruller_cfgs  # noqa: E402
from pixparse_tpu_torch.models.interop import (  # noqa: E402
    cruller_state_dict,
    load_cruller_state_dict,
)
from pixparse_tpu_torch.models.moonlight import MoonlightCfg, MoonlightCruller  # noqa: E402
from pixparse_tpu_torch.ops import moe  # noqa: E402
from pixparse_tpu_torch.ops.loss import cross_entropy_from_hidden  # noqa: E402

VOCAB = 96
TOL = dict(atol=2e-6, rtol=1e-5)
MARGIN = 1e-5


class Bf16:
    """The reference's products with both operands rounded to bfloat16."""

    def linear(self, x, w, b=None):
        y = torch.nn.functional.linear(x.bfloat16(), w.bfloat16()).float()
        return y if b is None else y + b

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a.bfloat16(), b.bfloat16()).float()


@pytest.fixture(scope="module")
def setup():
    vit_cfg, dec_cfg, _ = resolve_cruller_cfgs(get_model_config("cruller_moonlight_test"),
                                               vocab_size=VOCAB)
    model = create_cruller(vit_cfg, dec_cfg).init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():  # wider than the init, so the layers matter
            if p.dim() >= 2 and not name.startswith("image_encoder"):
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
        for layer in model.decoder.model.layers[dec_cfg.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.normal_(0.0, 0.1, generator=gen)
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randn(2, 64, 48, 1).astype(np.float32))
    text = torch.from_numpy(rng.randint(4, VOCAB, size=(2, 11)))
    target = torch.from_numpy(rng.randint(4, VOCAB, size=(2, 11)))
    target[1, 6:] = -100
    cfg = {"encoder": dict(patch_size=vit_cfg.patch_size, num_heads=vit_cfg.num_heads,
                           depth=vit_cfg.depth, ln_eps=vit_cfg.ln_eps),
           "decoder": dataclasses.asdict(dec_cfg)}
    return model, cfg, img, text, target


def _plain_params(model):
    p = {n: t.detach().clone().requires_grad_(True) for n, t in model.named_parameters()}
    p.update({n: b.detach().clone() for n, b in model.named_buffers()})
    return p


def _port_loss(model, img, text, target):
    hidden, table, shard = model.forward_hidden_head(img, text)
    return cross_entropy_from_hidden(hidden, table.to(hidden.dtype), target, vocab_shard=shard)[0]


def _check_own_choice(routes, record):
    k = routes[0].experts.shape[1]
    for r, (scores, own) in zip(routes, record):
        top = scores.topk(k + 1, dim=-1).values
        sure = (top[:, k - 1] - top[:, k]) > MARGIN
        same = (r.experts.sort(-1).values == own.sort(-1).values).all(-1)
        assert bool(same[sure].all())


def test_logits_loss_and_every_gradient_match_the_plain_reference(setup):
    model, cfg, img, text, target = setup
    model.zero_grad()
    with moe.record_routes() as routes:
        loss = _port_loss(model, img, text, target)
        logits = model(img, text)
    loss.backward()
    follow = [r.experts for r in routes[:len(routes) // 2]]
    p = _plain_params(model)
    record = []
    ref_logits = plain.logits(p, cfg, img, text, follow=follow, record=record)
    _check_own_choice(routes, record)
    ref_loss = plain.loss(p, cfg, img, text, target, follow=follow)
    torch.testing.assert_close(logits, ref_logits, **TOL)
    torch.testing.assert_close(loss, ref_loss, **TOL)
    names = [n for n, t in p.items() if t.requires_grad]
    grads = torch.autograd.grad(ref_loss, [p[n] for n in names])
    params = dict(model.named_parameters())
    assert set(names) == set(params)
    for n, g in zip(names, grads):
        scale = float(g.abs().max())
        torch.testing.assert_close(params[n].grad, g, atol=1e-6 + 1e-4 * scale, rtol=0, msg=n)
    assert all(float(g.abs().max()) > 0 for n, g in zip(names, grads) if "experts." in n)


def test_a_bf16_reference_fails_the_tolerance(setup):
    """The logits' tolerance is tight enough that bf16 products fail it."""
    model, cfg, img, text, target = setup
    with torch.no_grad(), moe.record_routes() as routes:
        logits = model(img, text)
    p = _plain_params(model)
    low = plain.logits(p, cfg, img, text, Bf16(), follow=[r.experts for r in routes]).detach()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(logits, low, **TOL)


def test_routing_chooses_on_biased_scores_and_weighs_by_unbiased_ones():
    torch.manual_seed(0)
    h = torch.randn(5, 16)
    w = torch.randn(8, 16)
    bias = torch.zeros(8)
    bias[3] = 5.0  # expert 3 chosen by every token, whatever its score
    r = moe.route(h, w, bias, top_k=3, scaling=2.446, norm_topk=True)
    s = torch.sigmoid(h @ w.t())
    assert bool((r.experts == 3).any(-1).all())
    own = torch.topk(s + bias, 3, dim=-1).indices  # tie-free: random scores
    assert torch.equal(r.experts.sort(-1).values, own.sort(-1).values)
    chosen = s.gather(1, r.experts)
    torch.testing.assert_close(r.weights, 2.446 * chosen / chosen.sum(-1, keepdim=True))
    torch.testing.assert_close(r.scores, s + bias)


def test_an_expert_left_empty_and_the_grouped_plain_products():
    torch.manual_seed(1)
    T, D, F_, E, k = 12, 16, 8, 6, 2
    h = torch.randn(T, D)
    gate = torch.randn(E, D)
    bias = torch.zeros(E)
    bias[4] = -10.0  # never chosen
    w1, w2 = torch.randn(E, 2 * F_, D), torch.randn(E, D, F_)
    r = moe.route(h, gate, bias, k, 1.0, True)
    srt = moe.sort_by_expert(r.experts, E)
    counts = torch.bincount(r.experts.reshape(-1), minlength=E)
    assert srt.offsets.tolist() == [0] + counts.cumsum(0).tolist() and counts[4] == 0
    xs = h[srt.order // k]
    y = moe.moe_expert_mm(xs, w1, srt.offsets)
    want = torch.stack([xs[i] @ w1[e].t() for i, e in enumerate(r.experts.reshape(-1)[srt.order])])
    torch.testing.assert_close(y, want)
    dw = moe.moe_expert_wgrad(y, xs, srt.offsets)
    assert dw.shape == (E, 2 * F_, D) and bool((dw[4] == 0).all())
    rows = slice(int(srt.offsets[1]), int(srt.offsets[2]))
    torch.testing.assert_close(dw[1], y[rows].t() @ xs[rows])
    out = moe.routed_experts(h, gate, bias, w1, w2, k, 1.0, True)
    ref = torch.zeros(T, D)
    for t in range(T):
        for j in range(k):
            e = int(r.experts[t, j])
            g, u = (h[t] @ w1[e].t()).chunk(2)
            ref[t] += r.weights[t, j] * (torch.nn.functional.silu(g) * u) @ w2[e].t()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_spans_counters_and_the_expert_tally(setup):
    model, _, img, text, _ = setup
    cfg = model.dec_cfg
    with torch.no_grad(), collect() as c:
        model(img, text)
        model(img, text)
    tokens = img.shape[0] * (model.vit_cfg.num_tokens + text.shape[1])
    k = cfg.num_experts_per_tok
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    assert c.counts["moe.routed_rows"] == 2 * moe_layers * tokens * k
    spans = c.totals()
    assert all(spans[n]["count"] == 2 * moe_layers for n in ("moe.route", "moe.experts",
                                                            "moe.combine"))
    rows = c.read_tallies()
    assert sorted(rows) == [f"moe.expert_rows.{i}" for i in range(1, cfg.num_hidden_layers)]
    assert all(len(v) == cfg.n_routed_experts and sum(v) == 2 * tokens * k for v in rows.values())


def test_decay_mask_state_dict_and_untied_head(setup):
    model = setup[0]
    mask = default_weight_decay_mask(dict(model.named_parameters()))
    layer = "text_decoder.trunk.model.layers.1."
    assert mask[layer + "mlp.experts.gate_up_proj"] and mask[layer + "mlp.experts.down_proj"]
    assert mask[layer + "mlp.gate.weight"] and mask["text_decoder.trunk.lm_head.weight"]
    assert not any(mask[n] for n in mask if n.endswith("norm.weight"))
    assert layer + "mlp.gate.e_score_correction_bias" not in mask
    sd = cruller_state_dict(model)
    assert layer + "mlp.gate.e_score_correction_bias" in sd
    fresh = create_cruller(model.vit_cfg, model.dec_cfg)
    load_cruller_state_dict(fresh, sd)
    for n, t in fresh.state_dict().items():
        assert torch.equal(t, sd[n]), n
    assert not torch.equal(sd["text_decoder.trunk.lm_head.weight"],
                           sd["text_decoder.trunk.model.embed_tokens.weight"])


def test_published_sizes_resolve_and_decode_is_refused():
    vit_cfg, dec_cfg, _ = resolve_cruller_cfgs(get_model_config("cruller_moonlight"),
                                               vocab_size=163840)
    assert dec_cfg == MoonlightCfg(num_hidden_layers=5, max_length=1024)
    assert (vit_cfg.num_tokens, vit_cfg.embed_dim, vit_cfg.in_chans) == (1009, 768, 1)
    with pytest.raises(NotImplementedError):
        create_cruller(vit_cfg, dec_cfg, kv_cache_dtype="bf16")
    with torch.device("meta"):
        model = MoonlightCruller(vit_cfg, dec_cfg)
    sizes = {}
    for n, p in model.named_parameters():
        part = n.split(".")[4] if ".layers." in n else n.split(".")[0]
        sizes[part] = sizes.get(part, 0) + p.numel()
    # the dense layer, then MoE layers of 553.6M routed, 17.3M shared, 13.8M MLA,
    # 0.13M router weights; 3.19B in all (16 B a parameter: 47.5 GiB to train)
    assert sizes["0"] == 82_973_184
    assert all(sizes[str(i)] == 584_847_872 for i in range(1, 5))
    assert sum(sizes.values()) == 3_185_255_680


def test_pretrain_task_and_app_train_run_the_test_model(tmp_path):
    """``TaskCrullerPretrain`` sets up, steps and logs the model from its
    registry name, and ``app.train`` runs it end to end on the CPU."""
    from pixparse_tpu_torch.app.train import main as train_main
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_cruller_pretrain import (
        TaskCrullerPretrain,
        TaskCrullerPretrainCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg
    from test_torch_train_cli import _make_shard, _train_args

    cfg = TaskCrullerPretrainCfg(
        model_name="cruller_moonlight_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        opt=OptimizationCfg(learning_rate=1e-3), dtype="float32", device="cpu", remat="auto")
    task = TaskCrullerPretrain(cfg, DeviceEnv.initialize("cpu"))
    task.train_setup(num_batches_per_interval=4)
    assert isinstance(task.model, MoonlightCruller) and task.auto_remat() is False
    rng = np.random.RandomState(0)
    text = rng.randint(4, task.vocab_size, size=(2, 12))
    batch = {"image": rng.randn(2, 64, 48, 1).astype(np.float32), "text": text,
             "target": np.where(np.arange(12) < 9, text, -100)}
    experts = "text_decoder.trunk.model.layers.1.mlp.experts.gate_up_proj"
    before = task.state.params[experts].detach().clone()
    losses = [float(task.train_step(batch)["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not torch.equal(before, task.state.params[experts])
    assert task.state_dict()[experts].shape == before.shape

    shard = str(tmp_path / "shard-00000.tar")
    _make_shard(shard, 8)
    args = _train_args(shard, str(tmp_path / "out"),
                       extra=["--task.model_name", "cruller_moonlight_test",
                              "--data.train.batch_size", "4", "--data.train.num_samples", "8"])
    assert train_main(args) == 0
    import glob

    pts = glob.glob(str(tmp_path / "out" / "**" / "*.pt"), recursive=True)
    assert pts and experts in torch.load(pts[0], map_location="cpu", weights_only=True)


@pytest.mark.parametrize("mode", ["full", "mlp"])
def test_remat_modes_give_the_same_gradients(setup, mode):
    """A layer checkpointed whole, or its FFN alone (the expert layer routes
    again in the recompute), gives the loss and gradients of no remat."""
    model, _, img, text, target = setup

    def grads():
        model.zero_grad()
        _port_loss(model, img, text, target).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    want = grads()
    model.remat = mode
    try:
        got = grads()
    finally:
        model.remat = False
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, atol=1e-7, rtol=1e-5, msg=n)


def test_chip_smoke_moonlight_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s ``train_moonlight`` phase rehearsed at
    ``cruller_moonlight_test``: the model drawn by the benchmark cell's
    weight rules, the routing that #19's kernel cases take their offsets
    from, and two train steps whose loss falls; off the card every wrapper
    takes its plain version, so no launch is counted."""
    import importlib.util
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    with cs.nan_default_init(torch):
        model, vit_cfg, dec_cfg = cs.moonlight_model(torch, "cruller_moonlight_test", "cpu", 300)
        bias = model.decoder.model.layers[1].mlp.gate.e_score_correction_bias
        assert 0.02 < float(bias.std()) < 0.3 and all(
            torch.isfinite(p).all() for p in model.parameters())
        batch = cs.moonlight_batch(torch, vit_cfg, 2, 31, 300, "cpu")
        offsets = cs.moonlight_offsets(torch, model, batch)
        moe_layers = dec_cfg.num_hidden_layers - dec_cfg.first_k_dense_replace
        rows = 2 * (vit_cfg.num_tokens + 31) * dec_cfg.num_experts_per_tok
        assert len(offsets) == moe_layers
        assert all(int(o[0]) == 0 and int(o[-1]) == rows and o.dtype == torch.int32
                   for o in offsets)
        counts = cs.phase_train_moonlight(torch, steps=2, B=2, model_name="cruller_moonlight_test",
                                          vocab=300, text_len=31, device="cpu")
    rec = json.loads((tmp_path / "phases.jsonl").read_text().splitlines()[-1])
    assert rec["phase"] == "train_moonlight" and set(counts.values()) == {0}
    assert rec["routed_rows_per_layer"] == rows and len(rec["max_over_mean_rows"]) == moe_layers
    assert rec["losses"][1] < rec["losses"][0]
