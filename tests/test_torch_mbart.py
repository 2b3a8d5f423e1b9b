"""The port's pre-LN mBART decoder layout (donut_base's decoder: pre-LN
layers, a final LayerNorm, embeddings scaled by sqrt(d_model)) against the
JAX package's, on the CPU at the ``bart-test`` width in fp32: teacher-forced
logits within 1e-4 and cached greedy tokens identical. The encoder is
``cruller_test``'s ViT; weights are a JAX init tree redrawn from a numpy
seed, moved with ``cruller_state_dict_from_jax``.
"""

import dataclasses

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
from pixparse_tpu_torch.ops.generation import generate

VOCAB, PAD = 512, 1
MBART = dict(pre_norm=True, add_final_layer_norm=True, scale_embedding=True)
SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5,
          "scale": 0.3}


@pytest.fixture(scope="module")
def pair():
    jv, jb, _ = jax_resolve(jax_model_config("cruller_test"), vocab_size=VOCAB)
    jm = JaxCruller(jv, dataclasses.replace(jb, **MBART))
    rng = np.random.RandomState(0)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 64, 48, 1)), jnp.zeros((3, 4), jnp.int32)
    ))["params"]

    def redraw(path, x):
        key = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x, np.float32)
        if key not in SCALES:
            return x
        noise = rng.normal(0.0, SCALES[key], x.shape).astype(np.float32)
        return x + noise if key == "scale" else noise  # LayerNorm gains stay near 1

    params = jax.tree_util.tree_map_with_path(redraw, init)
    v, b, _ = resolve_cruller_cfgs(get_model_config("cruller_test"), vocab_size=VOCAB)
    b = dataclasses.replace(b, **MBART)
    tm = Cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    assert "text_decoder.trunk.model.decoder.layer_norm.weight" in tm.state_dict()
    img = rng.randn(3, 64, 48, 1).astype(np.float32)
    return jm, params, tm.eval(), img


def test_pre_ln_teacher_forced_logits_match_jax(pair):
    jm, params, tm, img = pair
    txt = np.random.RandomState(1).randint(3, VOCAB, (3, 10))
    mask = np.ones_like(txt)
    mask[2, 6:] = 0
    ref = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt, jnp.int32),
                   attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_pre_ln_cached_greedy_tokens_identical_to_jax(pair):
    jm, params, tm, img = pair
    prompt = np.array([[0, 9], [0, PAD], [0, 4]])
    kw = dict(max_length=24, eos_token_id=2, pad_token_id=PAD)
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    ref = jax_generate(jm, params, jenc, jnp.asarray(prompt, jnp.int32), **kw)
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(img))
    out = generate(tm, tenc, torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(out.tokens[:, 2:].flatten().tolist())) > 3
