"""The port's greedy ``generate`` against the JAX package's, on the CPU.

``cruller_test`` in fp32 with the same weights (a JAX init tree redrawn
from a numpy seed, moved with ``cruller_state_dict_from_jax``): the token
buffers and ``lengths`` must be IDENTICAL, with variable-length padded
prompts, per-row ``max_new_tokens`` budgets and EOS early exit. On the CPU
the decode steps run the plain decode attention; the CUDA kernel is held
against it only on the card (chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.models import Cruller as JaxCruller
from pixparse_tpu.models import get_model_config as jax_model_config
from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.ops.generation import generate as jax_generate
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.generation import _left_align_prompts, generate

VOCAB, PAD, B = 512, 1, 4
# right-padded variable-length prompts (one row is a lone <s>)
PROMPT = np.array([[0, 5, PAD, PAD], [0, PAD, PAD, PAD], [0, 7, 9, 11], [0, 3, 4, PAD]])


@pytest.fixture(scope="module")
def pair():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb)
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 64, 48, 1)), jnp.zeros((B, 4), jnp.int32)
    ))["params"]
    scales = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}

    def redraw(path, x):
        std = scales.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    params = jax.tree_util.tree_map_with_path(redraw, init)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
    tm = Cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    img = rng.randn(B, 64, 48, 1).astype(np.float32)
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.eval().encode(torch.from_numpy(img))
    return jm, params, jenc, tm, tenc


def _both(pair, **kw):
    jm, params, jenc, tm, tenc = pair
    jkw, tkw = dict(kw), dict(kw)
    if "max_new_tokens" in kw:
        jkw["max_new_tokens"] = jnp.asarray(kw["max_new_tokens"])
        tkw["max_new_tokens"] = torch.as_tensor(kw["max_new_tokens"])
    ref = jax_generate(jm, params, jenc, jnp.asarray(PROMPT, jnp.int32), pad_token_id=PAD, **jkw)
    out = generate(tm, tenc, torch.from_numpy(PROMPT), pad_token_id=PAD, **tkw)
    return ref, out


def test_left_align_prompts():
    aligned, positions, valid = _left_align_prompts(torch.from_numpy(PROMPT), PAD)
    assert aligned.tolist()[0] == [PAD, PAD, 0, 5]
    assert positions.tolist()[0] == [0, 0, 0, 1]
    assert valid.tolist() == [2, 1, 4, 3]


def test_greedy_tokens_identical_to_jax(pair):
    ref, out = _both(pair, max_length=24, eos_token_id=-1)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    # the decode step of the last token is skipped (its logits are unused)
    assert out.steps == 24 - PROMPT.shape[1] - 1
    assert len(set(out.tokens[:, PROMPT.shape[1]:].flatten().tolist())) > 4


def test_eos_and_max_new_tokens_early_exit_identical_to_jax(pair):
    """EOS ends some rows, per-row budgets end the rest: the loop exits
    early and post-finish columns are pad, as in JAX."""
    free, _ = _both(pair, max_length=24, eos_token_id=-1)
    gen = np.asarray(free.tokens)[:, PROMPT.shape[1]:]
    eos = int(gen[0, 2])  # a token row 0 emits at its third step
    budget = np.array([20, 9, 5, 6])
    ref, out = _both(pair, max_length=24, eos_token_id=eos, max_new_tokens=budget)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    tokens = out.tokens.numpy()
    assert (tokens[:, -1] == PAD).all()  # every row finished before the end
    assert out.steps < 24 - PROMPT.shape[1] - 1
    for row in tokens:  # left-aligned prompt + tokens, then pad to the end
        real = np.flatnonzero(row != PAD)
        assert (np.diff(real) == 1).all()
