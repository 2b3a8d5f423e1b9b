"""The port's train step against the JAX package's on the CPU at the
``cruller_test`` size, fp32: a JAX ``Cruller`` init goes through
``cruller_state_dict_from_jax`` into the port's model, and the same numpy
batch goes through both train steps.

JAX and torch random streams cannot match, so every parity test runs with the
decoder's dropout rates at 0 on both sides; dropout has its own tests at the
end. Tolerances: one step's loss 1e-5 (fp32, other summation order); every
parameter's gradient atol = rtol = 5e-4, the bound the flash-attention tests
use (the ``flash`` variant runs the JAX Pallas kernels in interpret mode and
the port's plain kernel versions); the loss over three AdamW steps within
1e-3 relative (Adam's first steps divide by sqrt(v) ~ |g|, which amplifies
gradient noise on near-zero gradients).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixparse_tpu.framework.config import OptimizationCfg as JaxOptCfg
from pixparse_tpu.framework.optimization import create_optimizer as jax_create_optimizer
from pixparse_tpu.framework.train_state import create_train_state as jax_create_train_state
from pixparse_tpu.framework.train_state import make_train_step as jax_make_train_step
from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.ops import loss as jax_loss
from pixparse_tpu.parallel.mesh import create_mesh, shard_batch
from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.framework.optimization import create_optimizer
from pixparse_tpu_torch.framework.train_state import (
    create_train_state,
    dropout_seed,
    make_train_step,
)
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import (
    cruller_state_dict_from_jax,
    load_cruller_state_dict,
)
from pixparse_tpu_torch.ops.dense import dropout
from pixparse_tpu_torch.ops.loss import cross_entropy_from_hidden

VOCAB = 200
SCHED = (10, 1, 10)  # num_intervals, num_warmup_intervals, updates_per_interval
OPT = dict(learning_rate=1e-3, warmup_learning_rate=1e-4)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def _batch(n=8, text_len=16, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, 64, 48, 1).astype(np.float32)
    txt = rng.randint(4, VOCAB, size=(n, text_len)).astype(np.int32)
    tgt = np.roll(txt, -1, axis=1).astype(np.int32)
    tgt[:, -1] = -100
    tgt[0, :3] = -100
    return {"image": img, "text": txt, "target": tgt}


class Pair:
    """The JAX model, state and step beside the port's, from one init."""

    def __init__(self, attn_impl="xla", accum=1, opt=OPT, bart_overrides=NO_DROPOUT):
        jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
        jb = dataclasses.replace(jb, **bart_overrides)
        self.jmodel = JaxCruller(jv, jb, attn_impl=attn_impl)
        self.mesh = create_mesh()
        depth = dict(encoder_depth=jv.depth, decoder_layers=jb.decoder_layers)
        tx, _ = jax_create_optimizer(JaxOptCfg(**opt), *SCHED, **depth, wrap_multisteps=False)
        example = (jnp.zeros((8, 64, 48, 1)), jnp.zeros((8, 16), jnp.int32))
        self.jstate, _ = jax_create_train_state(self.jmodel, tx, self.mesh, example, seed=0)
        ce = (jax_loss.fused_cross_entropy_from_hidden if attn_impl == "flash"
              else jax_loss.cross_entropy_from_hidden)

        def jax_loss_fn(params, batch, rng):
            hidden = self.jmodel.apply(
                {"params": params}, batch["image"], batch["text"], deterministic=False,
                rngs={"dropout": rng}, method="forward_hidden",
            )
            emb = params["text_decoder"]["embed_tokens"]["embedding"]
            return ce(hidden, emb.astype(hidden.dtype), batch["target"])[0], {}

        self.jax_loss_fn = jax_loss_fn
        self.jstep = jax_make_train_step(
            jax_loss_fn, tx, self.mesh, donate=False, grad_accum_steps=accum)
        self.accum = accum

        v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
        self.vit_cfg, self.bart_cfg = v, dataclasses.replace(b, **bart_overrides)
        self.model = Cruller(v, self.bart_cfg, attn_impl=attn_impl).train()
        params = jax.tree_util.tree_map(np.asarray, self.jstate.params)
        load_cruller_state_dict(self.model, cruller_state_dict_from_jax(params, v, b))
        self.model.decoder.dropout_generator = torch.Generator()
        optimizer, _ = create_optimizer(OptimizationCfg(**opt), *SCHED, **depth)
        self.state = create_train_state(self.model, optimizer, seed=0)

        def loss_fn(batch):
            hidden = self.model.forward_hidden(batch["image"], batch["text"])
            loss, _ = cross_entropy_from_hidden(
                hidden, self.model.tied_embedding.to(hidden.dtype), batch["target"])
            return loss, {}

        self.loss_fn = loss_fn
        self.step = make_train_step(
            loss_fn, optimizer, reseed=self.model.decoder.dropout_generator.manual_seed,
            grad_accum_steps=accum)

    def jax_batch(self, batch):
        return shard_batch(self.mesh, batch, stacked=self.accum > 1)

    @staticmethod
    def torch_batch(batch):
        return {k: torch.from_numpy(v) if k == "image" else torch.from_numpy(v).long()
                for k, v in batch.items()}

    def jax_params_as_port(self):
        params = jax.tree_util.tree_map(np.asarray, self.jstate.params)
        return cruller_state_dict_from_jax(params, self.vit_cfg, self.bart_cfg, tied_head=False)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_one_step_loss_and_every_gradient_match_jax(attn_impl):
    pair = Pair(attn_impl)
    batch = _batch()
    (jl, _), jgrads = jax.value_and_grad(pair.jax_loss_fn, has_aux=True)(
        pair.jstate.params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = cruller_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), pair.vit_cfg, pair.bart_cfg, tied_head=False)
    loss, _ = pair.loss_fn(pair.torch_batch(batch))
    names = list(pair.state.params)
    grads = torch.autograd.grad(loss, [pair.state.params[n] for n in names])
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def test_three_adamw_steps_follow_jax():
    pair = Pair()
    batch = _batch()
    jb, tb = pair.jax_batch(batch), pair.torch_batch(batch)
    for i in range(3):
        pair.jstate, jm = pair.jstep(pair.jstate, jb)
        pair.state, tm = pair.step(pair.state, tb)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= 1e-3 * abs(jl), (i, tl, jl)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-3 * float(jm["grad_norm"])
        assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == 0
    assert pair.state.step == int(pair.jstate.step) == 3
    assert int(pair.state.opt_state["count"]) == 3
    want = pair.jax_params_as_port()
    for name, p in pair.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-4, err_msg=name)


def test_accumulation_over_two_micro_batches_equals_the_jax_stacked_step():
    pair = Pair(accum=2)
    mb1, mb2 = _batch(seed=1), _batch(seed=2)
    stacked = {k: np.stack([mb1[k], mb2[k]]) for k in mb1}
    pair.jstate, jm = pair.jstep(pair.jstate, pair.jax_batch(stacked))
    pair.state, tm = pair.step(pair.state, pair.torch_batch(stacked))
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
    assert pair.state.step == int(pair.jstate.step) == 1  # one update
    assert int(pair.state.opt_state["count"]) == 1
    want = pair.jax_params_as_port()
    for name, p in pair.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5, err_msg=name)
    # and the mean of the micro-batch gradients is what one update saw
    single = Pair(accum=1)
    l1, _ = single.loss_fn(single.torch_batch(mb1))
    l2, _ = single.loss_fn(single.torch_batch(mb2))
    assert abs(float(tm["loss"]) - 0.5 * float((l1 + l2).detach())) < 1e-6


def test_nonfinite_step_is_skipped_and_still_counts():
    pair = Pair()
    batch = pair.torch_batch(_batch())
    pair.state, _ = pair.step(pair.state, batch)  # a good step: moments are non-zero
    before = {k: v.detach().clone() for k, v in pair.state.params.items()}
    mu_before = {k: v.clone() for k, v in pair.state.opt_state["mu"].items()}
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    pair.state, metrics = pair.step(pair.state, bad)
    assert int(metrics["nonfinite"]) == 1 and not np.isfinite(float(metrics["loss"]))
    assert pair.state.step == 2  # the step counts
    assert int(pair.state.opt_state["count"]) == 1  # the update does not
    for k, v in pair.state.params.items():
        assert torch.equal(v.detach(), before[k]), k
    for k, v in pair.state.opt_state["mu"].items():
        assert torch.equal(v, mu_before[k]), k
    pair.state, metrics = pair.step(pair.state, batch)  # training goes on
    assert int(metrics["nonfinite"]) == 0 and int(pair.state.opt_state["count"]) == 2
    assert any(not torch.equal(v.detach(), before[k]) for k, v in pair.state.params.items())


# ---------------------------------------------------------------- dropout

def test_dropout_keep_rate_scaling_and_eval_identity():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = dropout(x, 0.1, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5e-3  # keep rate 1 - p
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))  # 1/(1-p) scaling
    assert dropout(x, 0.1, False, gen) is x  # eval mode is the identity
    assert dropout(x, 0.0, True, gen) is x
    assert torch.all(dropout(x, 1.0, True, gen) == 0)


def test_dropout_stream_follows_seed_step_and_micro_index():
    assert dropout_seed(1, 5) == dropout_seed(1, 5) != dropout_seed(1, 6)
    assert len({dropout_seed(s, t, m) for s in (1, 2) for t in range(4) for m in range(3)}) == 24
    assert all(0 <= dropout_seed(7, t) < 2 ** 63 for t in range(100))
    pair = Pair(bart_overrides=dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1))
    batch = pair.torch_batch(_batch())
    gen = pair.model.decoder.dropout_generator

    def hidden(step):
        gen.manual_seed(dropout_seed(pair.state.seed, step))
        with torch.no_grad():
            return pair.model.forward_hidden(batch["image"], batch["text"])

    a, a_again, b = hidden(3), hidden(3), hidden(4)
    assert torch.equal(a, a_again)  # a restart at the same step repeats the masks
    assert not torch.equal(a, b)  # the next step draws new ones
    pair.model.eval()
    e1, e2 = hidden(3), hidden(4)
    assert torch.equal(e1, e2) and not torch.equal(e1, a)  # eval: no dropout at all


def test_train_step_reseeds_per_step():
    """Two states at the same step see the same masks and land on the same
    parameters; the loss of the next step differs from a replay of this one."""
    rates = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
    p1, p2 = Pair(bart_overrides=rates), Pair(bart_overrides=rates)
    batch = p1.torch_batch(_batch())
    p1.state, m1 = p1.step(p1.state, batch)
    p2.state, m2 = p2.step(p2.state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in p1.state.params.items():
        assert torch.equal(v.detach(), p2.state.params[k].detach()), k
