"""The port's continuous batcher (``ops/serving.py``) against the JAX
package's, on the CPU, fp32.

The cases of the JAX package's ``tests/test_serving.py``: the same JAX init
(``PRNGKey(0)``) moved into the port's model by ``cruller_state_dict_from_jax``,
the same seeded pages. Every page's tokens from the port's
``ContinuousBatcher`` must equal both the JAX ``ContinuousBatcher``'s and
the JAX single-page ``generate``'s (``assert_array_equal``); with one slot
per page, also the JAX batched ``generate``'s. The compaction is checked
directly too: a step's decode logits on a cache compacted by
``KVCache.compact`` equal those on the cache before it within 1e-6. On the
CPU the decode steps run the plain decode attention; the kernels are held
on the card by ``chip_smoke.py``'s ``serve_stream`` phase, rehearsed here at
``cruller_test``: its own checks pass (the device-preprocessed encode and
train step equal the host path's, every page once, tokens equal to the
batched path's up to a tie) and it records its runs.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from pixparse_tpu.models.config import get_model_config as jax_model_config
from pixparse_tpu.models.cruller import Cruller as JaxCruller
from pixparse_tpu.models.cruller import resolve_cruller_cfgs as jax_resolve
from pixparse_tpu.ops.generation import generate as jax_generate
from pixparse_tpu.ops.serving import ContinuousBatcher as JaxBatcher
from pixparse_tpu_torch.models.bart import KVCache
from pixparse_tpu_torch.models.config import get_model_config
from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax, load_cruller_state_dict
from pixparse_tpu_torch.ops.serving import ContinuousBatcher

BATCHER = dict(slots=2, max_length=12, prompt_ids=[0], refill_size=2, chunk_steps=3)


@dataclasses.dataclass
class Setup:
    jmodel: object
    params: object
    jencode: object
    model: Cruller
    imgs: np.ndarray
    eos: int
    pad: int

    def encode(self, x):
        return self.model.encode(torch.from_numpy(np.asarray(x)))


_SETUPS = {}


def _setup(model_name="cruller_test", kv_cache_dtype="bf16", n_pages=9) -> Setup:
    """The JAX test's model and pages (``tests/test_serving.py::_setup``),
    and the port's model with the same weights; one per configuration."""
    key = (model_name, kv_cache_dtype)
    if key not in _SETUPS:
        jv, jb, _ = jax_resolve(jax_model_config(model_name))
        jm = JaxCruller(jv, jb, kv_cache_dtype=kv_cache_dtype)
        imgs = np.random.RandomState(0).rand(n_pages, *jv.img_size, jv.in_chans).astype(np.float32)
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs[:1]),
                            jnp.zeros((1, 4), jnp.int32))
        params = nn.unbox(variables["params"])
        jencode = jax.jit(lambda x: jm.apply({"params": params}, x, method="encode"))
        v, b, _ = resolve_cruller_cfgs(get_model_config(model_name))
        model = Cruller(v, b, kv_cache_dtype=kv_cache_dtype).eval()
        load_cruller_state_dict(model, cruller_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params), v, b))
        _SETUPS[key] = Setup(jm, params, jencode, model, imgs, jb.eos_token_id, jb.pad_token_id)
    return _SETUPS[key]


def _pages(s, n):
    return [(i, s.imgs[i]) for i in range(n)]


def _port(s, n, budgets=None, **kw):
    cfg = dict(BATCHER, eos_token_id=s.eos, pad_token_id=s.pad, **kw)
    batcher = ContinuousBatcher(s.model, **cfg)
    fn = (lambda pid: budgets[pid]) if budgets else None
    return batcher, list(batcher.run(_pages(s, n), s.encode, max_new_tokens=fn))


def _jax(s, n, budgets=None, **kw):
    cfg = dict(BATCHER, eos_token_id=s.eos, pad_token_id=s.pad, **kw)
    fn = (lambda pid: budgets[pid]) if budgets else None
    return list(JaxBatcher(s.jmodel, s.params, **cfg).run(_pages(s, n), s.jencode,
                                                           max_new_tokens=fn))


def _single_page(s, i, max_length, max_new=None):
    """JAX ``generate`` on page ``i`` alone: the gold result."""
    kw = {} if max_new is None else {"max_new_tokens": jnp.asarray([max_new], jnp.int32)}
    out = jax_generate(s.jmodel, s.params, s.jencode(jnp.asarray(s.imgs[i:i + 1])),
                       jnp.zeros((1, 1), jnp.int32), max_length=max_length,
                       eos_token_id=s.eos, pad_token_id=s.pad, **kw)
    return np.asarray(out.tokens[0, : int(out.lengths[0])])


CASES = {
    # name: (model, kv cache dtype, pages, per-page budgets, batcher settings)
    "no_refill": ("cruller_test", "bf16", 3, None, dict(slots=3)),
    "refill_per_page": ("cruller_test", "bf16", 5, None, {}),
    "forced_compaction": ("cruller_test", "bf16", 6, None, dict(capacity_slack=8, chunk_steps=2)),
    "ample_capacity": ("cruller_test", "bf16", 6, None, dict(capacity_slack=512, chunk_steps=2)),
    "per_page_budgets": ("cruller_test", "bf16", 4, {0: 3, 1: 7, 2: 1, 3: 5}, dict(max_length=16)),
    "short_stream": ("cruller_test", "bf16", 1, None, dict(slots=4)),
    "many_pool_groups": ("cruller_test", "bf16", 9, None, dict(pool_pages=2, chunk_steps=2)),
    "refill_cap": ("cruller_test", "bf16", 7, None,
                   dict(slots=3, max_refill_per_step=1, chunk_steps=2)),
    "int8_kv_cache": ("cruller_test", "int8", 5, None, {}),
    "swin": ("cruller_swin_test", "bf16", 4, None, dict(max_length=10)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batcher_tokens_equal_jax_batcher_and_single_page_generate(case):
    model_name, kv, n, budgets, kw = CASES[case]
    s = _setup(model_name, kv)
    batcher, got = _port(s, n, budgets, **kw)
    assert sorted(r.page_id for r in got) == list(range(n))  # each page once
    want = {r.page_id: r.tokens for r in _jax(s, n, budgets, **kw)}
    max_length = kw.get("max_length", BATCHER["max_length"])
    for r in got:
        assert r.length == len(r.tokens)
        budget = budgets[r.page_id] if budgets else None
        if budget:
            assert r.length - 1 <= budget
        np.testing.assert_array_equal(r.tokens, want[r.page_id], err_msg=f"page {r.page_id}")
        np.testing.assert_array_equal(
            r.tokens, _single_page(s, r.page_id, max_length, budget), err_msg=f"page {r.page_id}")
    assert batcher.refills == n
    if case == "forced_compaction":
        assert batcher.compactions > 0
    if case == "no_refill":  # one slot per page: the batched generate too
        g = jax_generate(s.jmodel, s.params, s.jencode(jnp.asarray(s.imgs[:n])),
                         jnp.zeros((n, 1), jnp.int32), max_length=max_length,
                         eos_token_id=s.eos, pad_token_id=s.pad)
        for r in got:
            i = r.page_id
            np.testing.assert_array_equal(
                r.tokens, np.asarray(g.tokens[i, : int(g.lengths[i])]), err_msg=f"page {i}")
    if case == "short_stream":
        assert list(batcher.run(iter([]), s.encode)) == []


def test_compaction_keeps_decode_logits():
    """Columns kept by a band mask per row, then gathered to the left by
    ``KVCache.compact``: the next decode step's logits equal those on the
    cache as it was (fp32, within 1e-6)."""
    s = _setup()
    model, C, B = s.model, 40, 3
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        enc = s.encode(s.imgs[:B])
        cache = KVCache(max_len=C)
        ids = torch.randint(4, 200, (B, 30), generator=gen)
        model.decode(ids[:, :2], enc, cache, mode="prefill")
        for t in range(2, 30):  # columns 0..29 written
            model.decode(ids[:, t:t + 1], enc, cache, mode="decode")
        cols = torch.arange(C)[None]
        lo, hi = torch.tensor([[3], [0], [17]]), torch.tensor([[21], [30], [18]])
        mask = (cols >= lo) & (cols < hi)
        mask[0, 9] = False  # a hole inside a band
        tok = torch.randint(4, 200, (B, 1), generator=gen)
        pos = torch.tensor([[5], [9], [2]])

        def step(cache, mask, col):
            cache.index = col
            mask = mask | (cols == col)
            return model.decode(tok, enc, cache, key_pad_mask=mask, mode="decode", positions=pos)

        before = step(dataclasses.replace(
            cache, self_k=[c.clone() for c in cache.self_k],
            self_v=[c.clone() for c in cache.self_v]), mask, 33)
        packed = cache.compact(mask)
        n = mask.sum(1, keepdim=True)
        assert torch.equal(packed, cols < n) and n.flatten().tolist() == [17, 30, 1]
        after = step(cache, packed, 35)
    torch.testing.assert_close(after, before, atol=1e-6, rtol=0)


def test_chip_smoke_serve_stream_phase_on_the_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    with cs.nan_default_init(torch):
        counts = cs.phase_serve_stream(torch, model_name="cruller_test", pages=6, slots=2,
                                       max_length=12, budgets=(2, 10), train_B=2, vocab=300,
                                       device="cpu")
    assert set(counts) == {"serve_stream_bf16", "serve_stream_int8"}
    assert not any(n for run in counts.values() for n in run.values())  # no kernel on the CPU
    rec = json.loads((tmp_path / "phases.jsonl").read_text().splitlines()[-1])
    assert rec["phase"] == "serve_stream" and rec["preprocess"]["input_bit_equal"]
    assert rec["train"]["bit_equal"]
    for mode, run in rec["runs"].items():
        assert run["continuous"]["refills"] == 6
        assert sorted(run["completion_order"]) == list(range(6))
        assert run["equal_pages"] + len(run["disagreements"]) == 6
        assert run["continuous"]["decode_steps"] > 0 and run["batched"]["decode_steps"] > 0
        assert run["continuous"]["plain_decode_calls"]["decode_attention_plain"] > 0
