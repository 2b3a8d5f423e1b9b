"""The port's sampled and naive generation, on the CPU.

- ``generate(sample=True)`` is reproducible per generator seed and
  differs across seeds, with the exact and with the int8 head; the draws
  cannot equal JAX's, so their distribution is held instead: one step's
  draws for 4096 repeats of one row pass a chi-square test against
  ``softmax(logits / 5.0)`` computed in fp64 (p > 1e-3, categories binned
  to 64 expected draws each), and the same draws fail it against
  ``softmax(logits)`` (the test can tell the temperature);
- ``generate_naive`` (the full-prefix oracle) gives JAX ``generate_naive``'s
  tokens, with ragged right-padded prompts and EOS, and the port's
  KV-cached ``generate``'s where prompts are not padded.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from pixparse_tpu.ops.generation import generate_naive as jax_generate_naive
from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.ops.generation import generate, generate_naive, select_next

from test_torch_generate_beam import PAD, PROMPTS, _pair

T, DRAWS, BINS = 5.0, 4096, 64


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _sample(tm, tenc, seed, max_length=16):
    return generate(
        tm, tenc, torch.from_numpy(PROMPTS["ragged"]), max_length=max_length, eos_token_id=-1,
        pad_token_id=PAD, sample=True, temperature=T,
        generator=torch.Generator().manual_seed(seed),
    ).tokens


@pytest.mark.parametrize("int8", [False, True])
def test_sampling_reproducible_per_seed_and_diverse(pair, int8):
    *_, tm, tenc = _pair(int8=True) if int8 else pair
    a, b, c = _sample(tm, tenc, 5), _sample(tm, tenc, 5), _sample(tm, tenc, 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy = generate(tm, tenc, torch.from_numpy(PROMPTS["ragged"]), max_length=16,
                      eos_token_id=-1, pad_token_id=PAD).tokens
    assert not torch.equal(a, greedy)
    assert torch.equal(a[:, :4] != PAD, greedy[:, :4] != PAD)  # the same left-aligned prompts


def _chi2_pvalue(draws, probs):
    """Categories sorted by probability and cut into ``BINS`` bins of equal
    expected count; Pearson's chi-square over the bins."""
    order = np.argsort(probs)
    edges = np.searchsorted(np.cumsum(probs[order]), np.arange(1, BINS) / BINS)
    bin_of = np.empty(len(probs), np.int64)
    bin_of[order] = np.searchsorted(edges, np.arange(len(probs)), side="right")
    expected = np.bincount(bin_of, weights=probs, minlength=BINS) * len(draws)
    observed = np.bincount(bin_of[draws], minlength=BINS)
    keep = expected > 0
    return stats.chisquare(observed[keep], expected[keep] * observed.sum() / expected[keep].sum()
                           ).pvalue


def test_one_step_draws_follow_the_tempered_softmax(pair):
    *_, tm, tenc = pair
    cache = KVCache(max_len=4)
    with torch.no_grad():
        logits = tm.decode(torch.zeros((1, 1), dtype=torch.long), tenc[:1], cache,
                           mode="prefill")[:, -1]
    rows = logits.expand(DRAWS, -1)
    draws = select_next(rows, True, T, torch.Generator().manual_seed(0)).numpy()
    assert draws.shape == (DRAWS,)
    x = logits[0].double().numpy()

    def softmax(z):
        e = np.exp(z - z.max())
        return e / e.sum()

    assert _chi2_pvalue(draws, softmax(x / T)) > 1e-3
    assert _chi2_pvalue(draws, softmax(x)) < 1e-3
    assert torch.equal(select_next(rows[:2], False), logits.argmax(-1).expand(2))


@pytest.mark.parametrize("prompt,eos", [("bos", -1), ("ragged", -1), ("ragged", "emitted")])
def test_naive_equals_jax_naive(pair, prompt, eos):
    jm, params, jenc, tm, tenc = pair
    p = PROMPTS[prompt]
    kw = dict(max_length=14, eos_token_id=-1, pad_token_id=PAD)
    out = generate_naive(tm, tenc, torch.from_numpy(p), **kw)
    if eos == "emitted":  # a token row 0 emits at its third step: rows end early
        kw["eos_token_id"] = int(out[0, p.shape[1] + 2])
        out = generate_naive(tm, tenc, torch.from_numpy(p), **kw)
        assert (out == PAD).sum() > (p == PAD).sum()
    ref = jax_generate_naive(jm, params, jenc, jnp.asarray(p, jnp.int32), **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.shape == (len(p), 14)
    assert len(set(out[:, p.shape[1]:].flatten().tolist())) > 4
    if prompt == "bos":  # unpadded prompts: the KV-cached decode agrees
        cached = generate(tm, tenc, torch.from_numpy(p), **kw)
        assert torch.equal(cached.tokens, out)
