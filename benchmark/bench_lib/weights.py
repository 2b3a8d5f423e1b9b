"""Seeded weights, made on the device in one draw.

Every parameter of the reference model (:func:`reference.model.
parameter_shapes`, the checkpoint's names) is a slice of one
``torch.randn`` over all of them, from a generator on the card seeded from
the run's seed, scaled by the rule of its kind (the configuration's
``init`` group) and rounded to the type the configuration serves in
(bfloat16), so that the program holds exactly these values whether it
keeps bf16 weights (eval) or fp32 master weights (training). The same
seed gives the same weights, and the reference is handed the same values
in float32.

Rules (``std`` is of a standard normal draw):

- dense and convolution weights: ``gain / sqrt(fan_in)``;
- biases: ``bias_std``;
- LayerNorm weights: ``1 + norm_std * n``; LayerNorm biases: ``norm_std * n``;
- the token table (also the tied head): ``token_std``;
- position tables, the class token and the relative-position bias tables:
  ``embed_std``;
- ``overrides``: ``[suffix, mean, std]`` for parameters whose name ends with
  ``suffix`` (the first that matches).
"""

from __future__ import annotations

from typing import Dict

from bench_lib.seeds import mix
from reference.model import norm_parameters, parameter_shapes

WEIGHTS_SALT = 0x5EED_0001


def _rule(name: str, shape, norms: Dict[str, str], init: Dict):
    for suffix, mean, std in init.get("overrides", []):
        if name.endswith(suffix):
            return float(mean), float(std)
    if name in norms:
        return (1.0 if norms[name] == "weight" else 0.0), init["norm_std"]
    if name.endswith("embed_tokens.weight"):
        return 0.0, init["token_std"]
    if name.endswith(("embed_positions.weight", "pos_embed", "cls_token",
                      "relative_position_bias_table")):
        return 0.0, init["embed_std"]
    if name.endswith(".bias"):
        return 0.0, init["bias_std"]
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    return 0.0, init["gain"] / fan_in ** 0.5


def seeded_weights(torch, cfg: Dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Name -> float32 tensor on ``device`` holding values of the served
    dtype (the configuration's ``dtype``)."""
    shapes = parameter_shapes(cfg)
    norms = norm_parameters(cfg)
    served = getattr(torch, cfg.get("dtype", "bfloat16"))
    total = sum(_numel(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, WEIGHTS_SALT))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = _numel(shape)
        mean, std = _rule(name, shape, norms, cfg["init"])
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(std).add_(mean)
        out[name] = leaf.to(served).float()
        at += n
    del flat
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
