"""The port's beam search against the JAX package's, on the CPU.

``cruller_test`` in fp32 with the same weights (a JAX init tree redrawn
from a numpy seed, moved with ``cruller_state_dict_from_jax``):

- ``num_beams=1`` gives the port's greedy tokens and JAX ``generate``'s;
- ``num_beams=4``: ``tokens`` and ``all_tokens`` equal JAX
  ``generate_beam``'s, ``scores`` and ``all_scores`` within 1e-4, at
  length penalties 1 and 0, with one-token and ragged right-padded prompts
  (the DocVQA layout), with EOS freezing some beams;
- the int8 mode (int8 cross caches, int8 head): the beam ignores the int8
  head, as JAX's does, and its tokens equal JAX's;
- ``KVCache.reorder`` equals a gather of the whole buffers, leaves the
  cross caches and keeps the contiguous layout; ``repeat_rows`` equals a
  prefill of repeated rows;
- the best beam's summed log-prob at ``length_penalty=0`` is at least the
  greedy sequence's.

The decode steps run the plain decode attention here; the CUDA kernels
are held against it on the card (chip_smoke.py ``beam_eval``).
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
from pixparse_tpu.ops.generation import generate_beam as jax_generate_beam
from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.generation import generate, generate_beam, top_k

VOCAB, PAD, B, MAX_LEN = 512, 1, 4, 16
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}
PROMPTS = {
    "bos": np.zeros((B, 1), np.int64),
    # right-padded questions of different lengths (one row a lone <s>)
    "ragged": np.array([[0, 5, PAD, PAD], [0, PAD, PAD, PAD], [0, 7, 9, 11], [0, 3, 4, PAD]]),
}


def _pair(int8=False):
    kw = dict(kv_cache_dtype="int8", lm_head_dtype="int8") if int8 else {}
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, jb, **kw)
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 64, 48, 1)), jnp.zeros((B, 4), jnp.int32)
    ))["params"]

    def redraw(path, x):
        std = SCALES.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    params = jax.tree_util.tree_map_with_path(redraw, init)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
    tm = Cruller(v, b, **kw)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    img = rng.randn(B, 64, 48, 1).astype(np.float32)
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.eval().encode(torch.from_numpy(img))
    return jm, params, jenc, tm, tenc


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _beams(pair, prompt, **kw):
    jm, params, jenc, tm, tenc = pair
    ref = jax_generate_beam(
        jm, params, jenc, jnp.asarray(prompt, jnp.int32), max_length=MAX_LEN, pad_token_id=PAD, **kw)
    out = generate_beam(tm, tenc, torch.from_numpy(prompt), max_length=MAX_LEN, pad_token_id=PAD, **kw)
    return ref, out


def _assert_same_beams(ref, out):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.all_tokens.numpy(), np.asarray(ref.all_tokens))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        out.all_scores.numpy(), np.asarray(ref.all_scores), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_one_beam_is_greedy_and_equal_to_jax(pair, prompt):
    jm, params, jenc, tm, tenc = pair
    p = PROMPTS[prompt]
    kw = dict(max_length=MAX_LEN, eos_token_id=-1, pad_token_id=PAD)
    greedy = generate(tm, tenc, torch.from_numpy(p), **kw)
    beam = generate_beam(tm, tenc, torch.from_numpy(p), num_beams=1, **kw)
    ref = jax_generate(jm, params, jenc, jnp.asarray(p, jnp.int32), **kw)
    np.testing.assert_array_equal(beam.tokens.numpy(), greedy.tokens.numpy())
    np.testing.assert_array_equal(beam.tokens.numpy(), np.asarray(ref.tokens))
    assert beam.steps == greedy.steps == MAX_LEN - p.shape[1] - 1
    assert beam.all_tokens.shape == (B, 1, MAX_LEN)


@pytest.mark.parametrize("length_penalty", [1.0, 0.0])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_four_beams_identical_to_jax(pair, prompt, length_penalty):
    p = PROMPTS[prompt]
    ref, out = _beams(pair, p, num_beams=4, eos_token_id=-1, length_penalty=length_penalty)
    _assert_same_beams(ref, out)
    assert len(set(out.all_tokens[:, :, p.shape[1]:].flatten().tolist())) > 8
    # an EOS the beams emit: some finish early and are frozen at pad
    eos = int(out.all_tokens[0, 1, p.shape[1] + 1])
    ref, out = _beams(pair, p, num_beams=4, eos_token_id=eos, length_penalty=length_penalty)
    _assert_same_beams(ref, out)
    finished = (out.all_tokens == eos).any(dim=-1)
    assert finished.any()
    for row in out.all_tokens[finished]:  # pad after the EOS, to the end
        after = row[int(np.flatnonzero(row.numpy() == eos)[0]) + 1:]
        assert bool((after == PAD).all())


def test_int8_mode_beam_ignores_the_int8_head_as_jax_does():
    jm, params, jenc, tm, tenc = _pair(int8=True)
    p = PROMPTS["ragged"]
    kw = dict(num_beams=4, max_length=MAX_LEN, eos_token_id=2, pad_token_id=PAD)
    ref = jax_generate_beam(jm, params, jenc, jnp.asarray(p, jnp.int32), **kw)
    out = generate_beam(tm, tenc, torch.from_numpy(p), **kw)
    _assert_same_beams(ref, out)
    # the same beams with the exact head the model's bf16 mode would use
    tm.lm_head_dtype = "bf16"
    exact = generate_beam(tm, tenc, torch.from_numpy(p), **kw)
    tm.lm_head_dtype = "int8"
    np.testing.assert_array_equal(exact.all_tokens.numpy(), out.all_tokens.numpy())


def test_kv_cache_reorder_and_repeat_rows(pair):
    *_, tm, tenc = pair
    K, rng = 3, np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(4, VOCAB, (B, 5)))
    with torch.no_grad():
        once = KVCache(max_len=MAX_LEN)
        tm.decode(ids[:, :3], tenc, once, mode="prefill")
        once.repeat_rows(K)
        rows = KVCache(max_len=MAX_LEN)
        tm.decode(ids[:, :3].repeat_interleave(K, 0), tenc.repeat_interleave(K, 0), rows,
                  mode="prefill")
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            for a, b in zip(getattr(once, name), getattr(rows, name)):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        assert torch.equal(once.cross_mask, rows.cross_mask)
        for t in range(3, 5):  # two steps, so the prefix spans prefill and decode
            tm.decode(ids[:, t:t + 1].repeat_interleave(K, 0), tenc, once, mode="decode")
    # a source row per row, within each sample
    src = torch.from_numpy((np.arange(B)[:, None] * K + rng.randint(0, K, (B, K))).reshape(-1))
    before = {n: [c.clone() for c in getattr(once, n)] for n in ("self_k", "self_v", "cross_k",
                                                                  "cross_v")}
    ptrs = [c.data_ptr() for c in once.self_k]
    once.reorder(src)
    for n in ("self_k", "self_v"):
        for old, new in zip(before[n], getattr(once, n)):
            assert torch.equal(new, old[src])  # the written prefix gathered, zeros elsewhere
            assert new.is_contiguous() and new.stride(1) == new.shape[2]
    assert [c.data_ptr() for c in once.self_k] == ptrs  # written back in place
    for n in ("cross_k", "cross_v"):
        assert all(torch.equal(a, b) for a, b in zip(before[n], getattr(once, n)))


def test_top_k_orders_ties_by_index_as_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, -np.inf],
                  [-np.inf, 0.5, -np.inf, 0.5, -np.inf, -np.inf, 0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_score_dominates_greedy(pair):
    """With ``length_penalty=0`` the best beam's summed log-prob, scored by
    one teacher-forced pass, is at least the greedy sequence's."""
    *_, tm, tenc = pair
    p = torch.zeros((1, 1), dtype=torch.long)
    kw = dict(max_length=12, eos_token_id=2, pad_token_id=PAD)
    g = generate(tm, tenc[:1], p, **kw)
    b = generate_beam(tm, tenc[:1], p, num_beams=4, length_penalty=0.0, **kw)

    def seq_logprob(row):
        ids = row[None]
        with torch.no_grad():
            logits = tm.decode(ids, tenc[:1], attention_mask=ids != PAD, mode="train")
        lp = torch.log_softmax(logits.float(), -1)[0]
        total = 0.0
        for t in range(1, ids.shape[1]):
            if int(row[t]) == PAD:
                break
            total += float(lp[t - 1, row[t]])
        return total

    assert seq_logprob(b.tokens[0]) >= seq_logprob(g.tokens[0]) - 1e-4
    assert abs(seq_logprob(b.tokens[0]) - float(b.scores[0])) < 1e-3  # the score is that sum
    assert b.all_tokens.shape == (1, 4, 12) and torch.isfinite(b.all_scores).all()
