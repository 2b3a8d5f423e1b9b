"""What the expert-layer cells need beside the shared harness: seeded
weights a leaf at a time, the program's resolved sizes against the
configuration file, the train step's matmul FLOPs, the bounds of the grouped
expert kernel (``csrc/moe_expert_mm.cu``) and the routing check.

Weights. Every leaf of :func:`reference.moonlight.parameter_shapes` (the
checkpoint's names, the routers' correction biases included) is drawn on
the device by a generator of its own, seeded from the run's seed and the
leaf's name, scaled by the rule of its kind (the configuration's ``init``
group, as :mod:`bench_lib.weights` writes them, with a stacked expert
weight's fan-in its last axis) and rounded to the served type. So any leaf
can be drawn again alone: the check reads each leaf's change after the
first steps against its start without holding a second copy of 3.19B
parameters.

Routing check. ``route_gap``: over the first steps' routing calls, the
token-slots whose expert in the program's choice is not in the reference's
own top k, counted only at tokens where the reference's k-th and (k+1)-th
scores lie more than the cell's ``route_margin`` apart (elsewhere the two
may order the experts otherwise by rounding, and the reference took the
program's choice), over all token-slots. ``score_gap``: the largest gap
between the program's router scores and the reference's (no limit; it is
what ``route_margin`` is set from).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

from bench_lib.flops import encoder_flops, encoder_tokens
from bench_lib.seeds import mix
from bench_lib.weights import _rule
from reference.moonlight import norm_parameters, parameter_shapes

WEIGHTS_SALT = 0x5EED_00E0


def _leaf_rule(name, shape, norms, init):
    if len(shape) == 3:  # a stacked (E, out, in) expert weight: the fan-in is its last axis
        return _rule(name, shape[-2:], norms, init)
    return _rule(name, shape, norms, init)


def leaf_weight(torch, cfg: Dict, seed: int, name: str, shape, device, norms=None):
    """One leaf, float32 on ``device``, holding values of the served dtype."""
    norms = norm_parameters(cfg) if norms is None else norms
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, WEIGHTS_SALT ^ zlib.crc32(name.encode())))
    mean, std = _leaf_rule(name, shape, norms, cfg["init"])
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    t.mul_(std).add_(mean)
    return t.to(getattr(torch, cfg.get("dtype", "bfloat16"))).float()


def seeded_weights(torch, cfg: Dict, seed: int, device) -> Dict:
    """Name -> float32 tensor on ``device`` for every leaf."""
    norms = norm_parameters(cfg)
    return {n: leaf_weight(torch, cfg, seed, n, s, device, norms)
            for n, s in parameter_shapes(cfg).items()}


def delta_norms(torch, cfg: Dict, seed: int, params: Dict, device) -> Dict[str, float]:
    """Each leaf's change from its seeded start, as its norm; a leaf at a
    time."""
    norms = norm_parameters(cfg)
    out = {}
    for n, t in params.items():
        start = leaf_weight(torch, cfg, seed, n, tuple(t.shape), device, norms)
        out[n] = float(torch.linalg.vector_norm(t.detach().float() - start))
        del start
    return out


# keys of the configuration file (HF DeepSeek-V3's) -> the program's resolved decoder cfg
DECODER_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                "intermediate_size", "moe_intermediate_size", "n_routed_experts",
                "n_shared_experts", "num_experts_per_tok", "first_k_dense_replace",
                "routed_scaling_factor", "norm_topk_prob", "rms_norm_eps", "rope_theta")


def check_sizes(cfg: Dict, enc_cfg, dec_cfg) -> None:
    """The program's resolved model sizes are the configuration file's."""
    enc = cfg["encoder"]
    want = {"img_size": tuple(enc["image_size"]), "in_chans": enc["in_chans"],
            "patch_size": enc["patch_size"], "embed_dim": enc["embed_dim"],
            "depth": enc["depth"], "num_heads": enc["num_heads"], "mlp_ratio": enc["mlp_ratio"],
            "ln_eps": enc["ln_eps"], "use_cls_token": enc["cls_token"]}
    bad = {k: (getattr(enc_cfg, k, None), v) for k, v in want.items()
           if getattr(enc_cfg, k, None) != v}
    bad.update({k: (getattr(dec_cfg, k, None), cfg[k]) for k in DECODER_KEYS
                if getattr(dec_cfg, k, None) != cfg[k]})
    if cfg["q_lora_rank"] is not None or cfg["tie_word_embeddings"]:
        bad["q_lora_rank / tie_word_embeddings"] = (cfg["q_lora_rank"], cfg["tie_word_embeddings"])
    if bad:
        raise ValueError(f"the program's model differs from the configuration: {bad}")


def layer_flops(cfg: Dict, L: int, moe: bool) -> float:
    """Forward matmul FLOPs of one decoder layer at length L (the program's
    convention, ``framework/profiling.py::moonlight_layer_flops``): the MLA
    projections, its score and value products over the full L x L, and the
    dense MLP or the router, the k routed and the shared experts."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, v, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
    attn = 2 * L * (D * H * (nope + rd) + D * (r + rd) + r * H * (nope + v) + H * v * D)
    attn += 2 * L * L * H * (nope + rd + v)
    if not moe:
        return float(attn + 6 * L * D * cfg["intermediate_size"])
    ffn = 6 * L * D * cfg["moe_intermediate_size"] * (cfg["num_experts_per_tok"]
                                                     + cfg["n_shared_experts"])
    return float(attn + ffn + 2 * L * D * cfg["n_routed_experts"])


def train_step_flops(cfg: Dict, batch: int, text_len: int) -> float:
    """Matmul FLOPs of one forward and backward train step (backward twice
    the forward): the ViT, the projector, the decoder over the page rows and
    the text, the untied head over the text."""
    enc = cfg["encoder"]
    N, D = encoder_tokens(enc), cfg["hidden_size"]
    f = encoder_flops(enc) + 2 * N * (enc["embed_dim"] * D + D * D)
    L = N + text_len
    f += sum(layer_flops(cfg, L, i >= cfg["first_k_dense_replace"])
             for i in range(cfg["num_hidden_layers"]))
    f += 2 * text_len * D * cfg["vocab_size"]
    return 3.0 * batch * f


def expert_calls(cfg: Dict, rows: int, active: int) -> List:
    """``(flops, bytes)`` of the six grouped products of one expert layer
    over ``rows`` (token, slot) rows, ``active`` experts with rows: the
    forward's ``[gate|up]`` and ``down``, the backward's ``dH``, ``dX``,
    ``dW_down`` and ``dW_gate_up``. Operations ``2 rows K N``; bytes the rows
    in, the weights of experts with rows and the output, once each, bf16."""
    D, Fe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    out = []
    for K, N in ((D, 2 * Fe), (Fe, D), (D, Fe), (2 * Fe, D)):  # row products
        out.append((2.0 * rows * K * N, 2.0 * (rows * K + active * K * N + rows * N)))
    for M, N in ((D, Fe), (2 * Fe, D)):  # weight gradients: rows are the reduction
        out.append((2.0 * rows * M * N, 2.0 * (rows * M + rows * N + active * M * N)))
    return out


def expert_launches(cfg: Dict) -> Dict[str, int]:
    """The grouped kernels' launches in one train step: per expert layer
    four row products and two weight gradients."""
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return {"moe_expert_mm": 4 * layers, "moe_expert_wgrad": 2 * layers}


def route_numbers(torch, prog_routes: List, ref_routes: List) -> Dict[str, float]:
    """``route_gap`` and ``score_gap`` (the module's docstring) of one run's
    first steps: ``prog_routes[step][call] = (experts (T, k), scores (T,
    E))``, ``ref_routes[step][call] = (scores, own (T, k), sure (T,))``."""
    wrong = slots = 0
    score_gap = 0.0
    for prog_step, ref_step in zip(prog_routes, ref_routes):
        if len(prog_step) != len(ref_step):
            return {"route_gap": float("inf"), "score_gap": float("inf")}
        for (experts, scores), (ref_scores, own, sure) in zip(prog_step, ref_step):
            experts = experts.long()
            slots += experts.numel()
            hit = (experts[:, :, None] == own.long()[:, None, :]).any(-1)  # (T, k)
            wrong += int((~hit & sure[:, None]).sum())
            score_gap = max(score_gap, float((scores.float() - ref_scores.float()).abs().max()))
    return {"route_gap": wrong / slots if slots else float("inf"), "score_gap": score_gap}


def load_max(expert_rows: Optional[Dict[str, List[int]]]) -> Optional[float]:
    """The mean over expert layers of the busiest expert's rows over the
    mean rows an expert (1: even loads)."""
    if not expert_rows:
        return None
    ratios = [max(v) * len(v) / sum(v) for v in expert_rows.values() if sum(v) > 0]
    return sum(ratios) / len(ratios) if ratios else None
