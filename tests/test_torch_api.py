"""The port's public API against the JAX package's: every name a JAX
package ``__init__.py`` exports (read with ``ast``: its ``from ... import``
names, and the public functions, classes and constants it defines) is
importable from the port's counterpart, except those in ``NOT_PORTED``;
the registries and ``make_attention_bias`` give what JAX's give.
"""

import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "pixparse_tpu"

# every exported name the port does not have, each with its reason: the one
# place they are listed ("parallel.*": the whole package)
NOT_PORTED = {
    "framework.jax_key": "a JAX PRNG key; the port seeds torch.Generator objects",
}


def _exports(init: Path):
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)
                      and (not t.id.startswith("_") or t.id == "__version__")]
    return names


PACKAGES = sorted(
    ".".join(p.relative_to(JAX_PKG).parts[:-1]) for p in JAX_PKG.rglob("__init__.py")
)


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_is_importable_from_the_port(package):
    names = _exports(JAX_PKG.joinpath(*package.split("."), "__init__.py") if package
                     else JAX_PKG / "__init__.py")
    if f"{package}.*" in NOT_PORTED:
        return
    module = importlib.import_module(".".join(filter(None, ["pixparse_tpu_torch", package])))
    missing = [n for n in names if not hasattr(module, n) and f"{package}.{n}" not in NOT_PORTED]
    assert missing == []


def test_the_exclusions_are_still_missing():
    """An excluded name that the port gains leaves the list."""
    for key in NOT_PORTED:
        package, name = key.rsplit(".", 1)
        try:
            module = importlib.import_module(f"pixparse_tpu_torch.{package}")
        except ModuleNotFoundError:
            continue
        assert name == "*" or not hasattr(module, name), key


def test_layers_are_the_models_blocks():
    from pixparse_tpu_torch import layers
    from pixparse_tpu_torch.models import bart, swin, vit
    from pixparse_tpu_torch.ops import attention, flash_attention

    assert (layers.ViTAttention, layers.ViTBlock, layers.ViTMlp) == (vit.Attention, vit.Block, vit.Mlp)
    assert layers.SwinBlock is swin.SwinBlock and layers.CachedSelfAttention is bart.CachedSelfAttention
    assert layers.flash_attention is flash_attention.flash_attention
    assert layers.make_attention_bias is attention.make_attention_bias


def test_list_models_equals_jax():
    """The port's registry is the JAX package's, in its order, plus the
    Moonlight prefix-LM presets, which only the port has."""
    from pixparse_tpu.models import list_models as jax_list
    from pixparse_tpu_torch.models import get_model_config, list_models

    port_only = {"cruller_moonlight", "cruller_moonlight_test"}
    assert [name for name in list_models() if name not in port_only] == jax_list()
    assert port_only <= set(list_models())
    assert all(get_model_config(name) is not None for name in list_models())


def test_tokenizer_registry_equals_jax():
    from pixparse_tpu import tokenizers as jt
    from pixparse_tpu_torch import tokenizers as tt

    assert tt.list_tokenizers() == jt.list_tokenizers() == ["tokenizer_bytelevel", "tokenizer_hf"]
    for name in tt.list_tokenizers() + ["missing"]:
        got, want = tt.get_tokenizer_config(name), jt.get_tokenizer_config(name)
        assert (got and dataclasses.asdict(got)) == (want and dataclasses.asdict(want))
    cfg = tt.get_tokenizer_config("tokenizer_bytelevel")
    cfg.name = "changed"  # a copy: the registry keeps its entry
    assert tt.get_tokenizer_config("tokenizer_bytelevel").name == tt.LOCAL_TOKENIZER_NAME
    tok = tt.TokenizerHF(tt.get_tokenizer_config("tokenizer_bytelevel")).trunk
    assert isinstance(tok, tt.ByteLevelTokenizer)
    assert tok("ab").input_ids == tt.create_bytelevel_tokenizer()("ab").input_ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_attention_bias_equals_jax(dtype):
    import jax.numpy as jnp

    from pixparse_tpu.ops.attention import make_attention_bias as jax_bias
    from pixparse_tpu_torch.ops.attention import make_attention_bias

    mask = np.random.RandomState(0).rand(3, 7) > 0.4
    got = make_attention_bias(torch.from_numpy(mask), dtype)
    want = jax_bias(jnp.asarray(mask), jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    assert got.shape == (3, 1, 1, 7) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert make_attention_bias(None) is None
