"""cruller_large in the port against the JAX package, on the CPU.

- ``resolve_cruller_cfgs(get_model_config(name))`` of the port gives the
  JAX package's resolved encoder and decoder fields and image stats, for
  ``cruller_large`` and ``cruller_large_6layers`` (a ViT-L/14 CLIP encoder
  with ``pre_norm`` on 798x616 grayscale pages, 2509 tokens; bart-large
  decoders of 10 and 6 layers), and the eval task picks the ``mlp`` remat
  for it;
- at full width (1024, 16 heads, the 50265-entry table) with one encoder
  layer, one decoder layer and a 112x112 page, fp32, from the same weights:
  the encoder output agrees within 1e-4 and greedy tokens are identical to
  JAX's. Full depth runs only on the card (chip_smoke.py ``large``).
"""

import dataclasses
from types import SimpleNamespace

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
from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask

SCALES = {"kernel": 0.05, "bias": 0.02, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}


def auto_remat(vit_cfg):
    """The train task's automatic remat rule (``auto_remat``) for an encoder cfg."""
    return BaseCrullerTrainTask.auto_remat(SimpleNamespace(vit_cfg=vit_cfg))


@pytest.mark.parametrize("name,layers", [("cruller_large", 10), ("cruller_large_6layers", 6)])
def test_resolved_configs_equal_to_jax(name, layers):
    want = jax_resolve(jax_model_config(name))
    got = resolve_cruller_cfgs(get_model_config(name))
    for g, w in zip(got[:2], want[:2]):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert got[2] == want[2]
    vit, bart, _ = got
    assert (vit.num_tokens, vit.depth, vit.num_heads, vit.embed_dim, vit.pre_norm) == (
        2509, 24, 16, 1024, True)
    assert (bart.decoder_layers, bart.d_model, bart.decoder_attention_heads, bart.vocab_size) == (
        layers, 1024, 16, 50265)
    assert auto_remat(vit) == "mlp"


def test_full_width_reduced_depth_encoder_and_greedy_equal_to_jax():
    cut = lambda cfgs: (dataclasses.replace(cfgs[0], depth=1, img_size=(112, 112)),
                        dataclasses.replace(cfgs[1], decoder_layers=1))
    jv, jb = cut(jax_resolve(jax_model_config("cruller_large")))
    v, b = cut(resolve_cruller_cfgs(get_model_config("cruller_large")))
    jm = JaxCruller(jv, jb)
    init = nn.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 1)), jnp.zeros((1, 4), jnp.int32)
    ))["params"]
    rng = np.random.RandomState(0)

    def redraw(path, x):
        std = SCALES.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    params = jax.tree_util.tree_map_with_path(redraw, init)
    tm = Cruller(v, b)
    load_cruller_state_dict(tm, cruller_state_dict_from_jax(params, v, b))
    img = rng.randn(2, 112, 112, 1).astype(np.float32)
    jenc = jm.apply({"params": params}, jnp.asarray(img), method="encode")
    with torch.no_grad():
        tenc = tm.eval().encode(torch.from_numpy(img))
    assert tenc.shape == (2, 65, 1024)  # 8 x 8 patches of 14 + cls
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=1e-4, rtol=1e-4)
    prompt = np.zeros((2, 1), np.int64)
    kw = dict(max_length=10, eos_token_id=-1, pad_token_id=1)
    ref = jax_generate(jm, params, jenc, jnp.asarray(prompt, jnp.int32), **kw)
    out = generate(tm, tenc, torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(out.tokens[:, 1:].flatten().tolist())) > 3
