"""Optimization layer (counterpart of
:mod:`pixparse_tpu.framework.optimization`): the optax chain written as plain
functions on tensors, so the order of operations is optax's:

    clip -> adam / momentum / lamb -> + weight_decay * p on masked leaves
         -> layer-decay scale -> * -learning_rate(count)

It is deliberately not ``torch.optim.AdamW``: ``eps`` is added outside the
square root of the bias-corrected second moment, the decay joins the Adam
update before the layer-decay scale and the learning rate, and the decay mask
and layer depths are decided from the parameter's path exactly as the JAX
package decides them. The port's parameter names are mapped to the flax path
names in one place, :func:`flax_path_names`.

:meth:`Optimizer.update` is pure: it returns the updates and a new state and
changes neither its arguments nor the parameters, so the train step can drop
a non-finite step without a host sync. The update count lives on the
parameters' device for the same reason; the schedule is evaluated on it
there.

On the card, one process, ``adam`` / ``adamw`` and a clip of ``None`` or
``norm`` (:func:`fused_update_applies`), the train step takes
:meth:`Optimizer.fused_update` instead: the same arithmetic in two kernel
launches over all leaves (:mod:`pixparse_tpu_torch.ops.optimizer`), in
place, with the non-finite skip inside. The chain stays the reference the
tests hold it to and the path of every other case.

Under a mesh the chain runs on each rank's local shards of the FSDP2
parameters and gradients. What must be a quantity of the whole gradient or
parameter (the global norm, the adaptive clip's unit norms, LAMB's trust
ratio) takes a :class:`~pixparse_tpu_torch.parallel.mesh.ShardedParams`
(``shards``): partial sums are added over the shards (over the ``model``
ranks only for the parameters split there: a replicated one counts once),
the adaptive clip works on the gathered whole tensors (so a row-parallel
weight's unit norms cover its whole input dim).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from pixparse_tpu_torch.framework.config import OptimizationCfg
from pixparse_tpu_torch.ops.optimizer import FusedAdamWPlan, fused_adamw

Schedule = Callable[[object], torch.Tensor]
Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# schedule
# --------------------------------------------------------------------------

def _as_count(count) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count.to(torch.float32)
    return torch.tensor(float(count), dtype=torch.float32)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: constant ``init`` for non-positive ``steps``."""
    if steps <= 0:
        return lambda count: torch.full_like(_as_count(count), init)

    def schedule(count):
        c = _as_count(count).clamp(0, steps)
        frac = 1 - c / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    def schedule(count):
        c = _as_count(count).clamp(max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    def schedule(count):
        c = _as_count(count)
        return torch.where(c < boundary, first(c), second(c - boundary))

    return schedule


def create_scheduler(
    cfg: OptimizationCfg,
    num_intervals: int,
    num_warmup_intervals: int,
    updates_per_interval: int,
    min_lr: float = 0.0,
) -> Schedule:
    """Cosine with warmup over *updates*, from interval math. The schedule
    takes an update count (int or tensor) and returns a 0-dim fp32 tensor on
    the count's device."""
    warmup_steps = max(0, num_warmup_intervals * updates_per_interval)
    total_steps = max(1, num_intervals * updates_per_interval)
    decay_steps = max(1, total_steps - warmup_steps)
    warmup = _linear(cfg.warmup_learning_rate, cfg.learning_rate, warmup_steps)
    if cfg.scheduler in ("cosine", None, ""):
        alpha = 0.0 if cfg.learning_rate == 0.0 else min_lr / cfg.learning_rate
        return _join(warmup, _cosine(cfg.learning_rate, decay_steps, alpha), warmup_steps)
    if cfg.scheduler == "constant":
        if warmup_steps:
            return warmup
        return lambda count: torch.full_like(_as_count(count), cfg.learning_rate)
    if cfg.scheduler == "linear":
        return _join(warmup, _linear(cfg.learning_rate, min_lr, decay_steps), warmup_steps)
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


# --------------------------------------------------------------------------
# parameter paths: the port's names -> the JAX package's flax path names
# --------------------------------------------------------------------------

def flax_path_names(name: str) -> Tuple[str, ...]:
    """``image_encoder.trunk.blocks.3.attn.qkv.weight`` ->
    ``('image_encoder', 'blocks_3', 'attn', 'qkv', 'kernel')``: the path the
    same parameter has in the JAX package's tree. The decay mask and the
    layer depths read only these names. Swin names fold as the JAX Swin
    names its modules: ``layers.2.blocks.13`` -> ``layers_2_blocks_13`` (its
    MLP ``mlp.fc1`` -> ``mlp_fc1``), ``layers.2.downsample`` ->
    ``layers_2_downsample``, ``patch_embed.norm`` -> ``patch_norm``."""
    parts = name.split(".")
    tower = parts[0]
    rest = [p for p in parts[1:] if p != "trunk"]
    if tower == "text_decoder":
        rest = rest[2:] if rest[:2] == ["model", "decoder"] else rest
    out: List[str] = [tower]
    i = 0
    while i < len(rest):
        p = rest[i]
        nxt = rest[i + 1:i + 4]
        if (tower == "image_encoder" and p == "layers" and len(nxt) == 3
                and nxt[0].isdigit() and nxt[1] == "blocks" and nxt[2].isdigit()):
            out.append(f"layers_{nxt[0]}_blocks_{nxt[2]}")
            i += 4
            if rest[i:i + 2] in (["mlp", "fc1"], ["mlp", "fc2"]):
                out.append(f"mlp_{rest[i + 1]}")
                i += 2
            continue
        if (tower == "image_encoder" and p == "layers" and len(nxt) >= 2
                and nxt[0].isdigit() and nxt[1] == "downsample"):
            out.append(f"layers_{nxt[0]}_downsample")
            i += 3
            continue
        if p in ("blocks", "layers") and nxt[:1] and nxt[0].isdigit():
            out.append(f"{p}_{nxt[0]}")
            i += 2
            continue
        out.append(p)
        i += 1
    if len(out) >= 3 and out[-3:-1] == ["patch_embed", "proj"]:
        out = out[:-2] + [out[-1]]  # flax: patch_embed/{kernel,bias}
    if len(out) >= 3 and out[-3:-1] == ["patch_embed", "norm"]:
        out = out[:-3] + ["patch_norm", out[-1]]  # the Swin's patch LayerNorm
    leaf, owner = out[-1], out[-2] if len(out) > 1 else ""
    if leaf == "weight":
        if owner.startswith("embed_") or owner == "lm_head":
            out[-1] = "embedding"
        elif "norm" in owner:
            out[-1] = "scale"
        else:
            out[-1] = "kernel"
    if owner == "layer_norm":  # the decoder's final norm
        out[-2] = "final_norm"
    return tuple(out)


def cruller_layer_depth(names: Tuple[str, ...], encoder_depth: int, decoder_layers: int) -> int:
    """Depth id for a Cruller parameter path (flax names). 0 = input
    embeddings, max = decoder output side; other paths get max depth."""
    max_depth = encoder_depth + decoder_layers + 2
    if "image_encoder" in names:
        for n in names:
            if n.startswith("blocks_"):
                return int(n.split("_")[1]) + 1
            if n.startswith("layers_") and "_blocks_" in n:
                # Swin: layers_{stage}_blocks_{b} -> a coarse per-stage depth
                # spread over the encoder range, as the JAX package assigns it
                stage = int(n.split("_")[1])
                return min(1 + stage * max(1, encoder_depth // 4), encoder_depth)
        if any(n in ("patch_embed", "patch_norm", "cls_token", "pos_embed", "norm_pre")
               for n in names):
            return 0
        return encoder_depth + 1  # the final encoder norm sits atop the last block
    if "text_decoder" in names:
        base = encoder_depth + 1
        for n in names:
            if n.startswith("layers_"):
                return base + int(n.split("_")[1]) + 1
        if any(n in ("embed_tokens", "embed_positions", "layernorm_embedding") for n in names):
            # embed_tokens doubles as the tied LM head; it counts as input
            return base
        return max_depth
    return max_depth


def layer_decay_scales(
    params: Params, layer_decay: float, encoder_depth: int, decoder_layers: int
) -> Dict[str, float]:
    """Per-parameter learning-rate multiplier: ``decay ** (max_depth - depth)``."""
    max_depth = encoder_depth + decoder_layers + 2
    return {
        name: layer_decay ** (
            max_depth - cruller_layer_depth(flax_path_names(name), encoder_depth, decoder_layers)
        )
        for name in params
    }


_NO_DECAY_NAMES = ("pos_embed", "cls_token", "bias", "scale")


def default_weight_decay_mask(params: Params) -> Dict[str, bool]:
    """Decay only parameters with 2 or more dims, and never one whose path
    holds pos_embed, cls_token, bias or scale."""
    return {
        name: not any(n in _NO_DECAY_NAMES for n in flax_path_names(name)) and p.dim() >= 2
        for name, p in params.items()
    }


# --------------------------------------------------------------------------
# clipping
# --------------------------------------------------------------------------

def global_norm(tensors: List[torch.Tensor], shards=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32, on their device;
    with ``shards``, over the whole tensors whose local shards these are."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    if shards is not None:
        return shards.sum(torch.stack(norms).square()).sum().sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, shards=None) -> List[torch.Tensor]:
    g_norm = global_norm(grads, shards)
    # optax: unchanged below the threshold, else (g / norm) * max_norm
    factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
    return torch._foreach_mul(grads, factor)


def _jax_layout(name: str, t: torch.Tensor):
    """``(view, back)``: ``t`` in the shape the JAX package stores the
    parameter in (dense kernels ``(in, out)``, the patch kernel
    ``(p*p*C, D)``) and the function that maps a tensor of that shape back
    to the port's layout. Adaptive clipping takes its unit norms along the
    axes of the JAX shape."""
    if flax_path_names(name)[-1] == "kernel":
        if t.dim() == 4:
            d, c, ph, pw = t.shape
            return (t.permute(2, 3, 1, 0).reshape(-1, d),
                    lambda r: r.reshape(ph, pw, c, d).permute(3, 2, 0, 1))
        if t.dim() == 2:
            return t.t(), lambda r: r.t()
    return t, lambda r: r


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    if x.squeeze().dim() <= 1:
        sq = (x * x).sum().reshape([1] * x.dim())
    elif x.dim() in (2, 3):
        sq = (x * x).sum(dim=0, keepdim=True)
    elif x.dim() == 4:
        sq = (x * x).sum(dim=(0, 1, 2), keepdim=True)
    else:
        raise ValueError(f"adaptive clipping takes 1-4 dims, got {tuple(x.shape)}")
    return sq.sqrt().expand_as(x)


def _adaptive_grad_clip(names, grads, params, clipping: float, eps: float = 1e-3, shards=None):
    """With ``shards``: each gradient and parameter gathered whole, clipped
    as one process clips it, and this rank's rows taken back."""
    out = []
    for name, g, p in zip(names, grads, params):
        if shards is not None:
            g, p = shards.whole(name, g), shards.whole(name, p)
        (gv, back), (pv, _) = _jax_layout(name, g), _jax_layout(name, p)
        g_norm, p_norm = _unitwise_norm(gv), _unitwise_norm(pv)
        max_norm = clipping * p_norm.clamp_min(eps)
        clipped = gv * (max_norm / g_norm.clamp_min(1e-6))
        g = back(torch.where(g_norm < max_norm, gv, clipped)).contiguous()
        out.append(shards.shard(name, g) if shards is not None else g)
    return out


# --------------------------------------------------------------------------
# the chain
# --------------------------------------------------------------------------

def _resolve_state_dtype(name: str) -> torch.dtype:
    name = (name or "float32").lower()
    if name in ("float32", "fp32", "f32", ""):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown optimizer_state_dtype {name!r}")


class Optimizer:
    """The optax chain of the JAX package's ``create_optimizer`` as one
    object with ``init`` and a pure ``update``; and, where
    :func:`fused_update_applies`, :meth:`fused_update`, which changes the
    state's tensors in place.

    State: ``{"count": 0-dim int32 tensor, "mu": {...}, "nu": {...}}`` for
    Adam-family optimizers (moments in ``optimizer_state_dtype`` for
    ``adam``/``adamw``; always fp32 for ``lamb``, whose JAX chain takes
    ``optax.scale_by_adam`` whatever that option says),
    ``{"count", "trace"}`` for SGD with momentum, ``{"count"}`` for plain
    SGD. ``count`` is the number of updates applied; the learning rate is
    ``schedule(count)``.

    :meth:`fused_update` keeps the plan of its kernels (the leaves'
    tables, built on its first call) until the leaves move or :meth:`init`
    builds a new state: the plan holds the state's tensors, so a state
    given up stays alive no longer than that."""

    def __init__(self, cfg: OptimizationCfg, schedule: Schedule,
                 encoder_depth: int = 0, decoder_layers: int = 0):
        self.cfg = cfg
        self.schedule = schedule
        self.encoder_depth = encoder_depth
        self.decoder_layers = decoder_layers
        self.name = (cfg.optimizer or "adamw").lower()
        if self.name not in ("adamw", "adam", "sgd", "momentum", "lamb"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        mode = cfg.clip_grad_mode or "norm"
        if cfg.clip_grad_value is not None and mode not in ("norm", "value", "agc"):
            raise ValueError(f"unknown clip_grad_mode {mode!r}")
        self.clip_mode = mode if cfg.clip_grad_value is not None else None
        self.betas = tuple(cfg.betas) if cfg.betas else (0.9, 0.999)
        self.state_dtype = _resolve_state_dtype(cfg.optimizer_state_dtype)
        if self.name == "lamb":
            self.state_dtype = torch.float32
        momentum = cfg.momentum if cfg.momentum is not None else 0.9
        self.momentum = momentum if self.name in ("sgd", "momentum") else 0.0
        self._fused_plan = None  # FusedAdamWPlan of fused_update, built on its first call

    def init(self, params: Params) -> Dict:
        self._fused_plan = None  # it holds the tensors of the state this one replaces
        first = next(iter(params.values()))
        state: Dict = {"count": torch.zeros((), dtype=torch.int32, device=first.device)}
        if self.name in ("adamw", "adam", "lamb"):
            state["mu"] = {n: torch.zeros_like(p, dtype=self.state_dtype) for n, p in params.items()}
            state["nu"] = {n: torch.zeros_like(p, dtype=self.state_dtype) for n, p in params.items()}
        elif self.momentum:
            state["trace"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: Dict, params: Params,
               shards=None) -> Tuple[Params, Dict]:
        """``(updates, new_state)``; the new parameters are ``p + update``.
        ``shards``: the tensors are local shards of the parameters it holds."""
        cfg = self.cfg
        names = list(params)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        new_state: Dict = {}

        if self.clip_mode == "norm":
            g = _clip_by_global_norm(g, cfg.clip_grad_value, shards)
        elif self.clip_mode == "value":
            g = [t.clamp(-cfg.clip_grad_value, cfg.clip_grad_value) for t in g]
        elif self.clip_mode == "agc":
            g = _adaptive_grad_clip(names, g, p, cfg.clip_grad_value, shards=shards)

        count = state["count"] + 1
        new_state["count"] = count
        if self.name in ("adamw", "adam", "lamb"):
            b1, b2 = self.betas
            mu = [state["mu"][n].float() for n in names]
            nu = [state["nu"][n].float() for n in names]
            mu = torch._foreach_add(torch._foreach_mul(mu, b1), g, alpha=1.0 - b1)
            nu = torch._foreach_add(
                torch._foreach_mul(nu, b2), torch._foreach_mul(g, g), alpha=1.0 - b2
            )
            c = count.to(torch.float32)
            b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
            b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, b2c))
            torch._foreach_add_(denom, cfg.eps)
            u = torch._foreach_div(torch._foreach_div(mu, b1c), denom)
            new_state["mu"] = {n: m.to(self.state_dtype) for n, m in zip(names, mu)}
            new_state["nu"] = {n: v.to(self.state_dtype) for n, v in zip(names, nu)}
            decay = cfg.weight_decay if self.name in ("adamw", "lamb") else 0.0
        else:
            u = g
            if self.momentum:
                trace = torch._foreach_add(g, [state["trace"][n] for n in names], alpha=self.momentum)
                u = trace
                if self.name == "momentum":  # nesterov
                    u = torch._foreach_add(g, trace, alpha=self.momentum)
                new_state["trace"] = dict(zip(names, trace))
            decay = cfg.weight_decay

        if decay:
            mask = default_weight_decay_mask(params)
            u = [ui + decay * pi if mask[n] else ui for n, ui, pi in zip(names, u, p)]

        if self.name == "lamb":
            if shards is not None:  # one sum over the shards for every norm
                sq = shards.sum(torch.stack([t.float().square().sum() for t in p + u]))
                norms = list(zip(sq[:len(p)].sqrt(), sq[len(p):].sqrt()))
            else:
                norms = [(torch.linalg.vector_norm(pi), torch.linalg.vector_norm(ui))
                         for ui, pi in zip(u, p)]
            scaled = []
            for ui, (p_norm, u_norm) in zip(u, norms):
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                scaled.append(ui * ratio)
            u = scaled

        if cfg.layer_decay is not None and cfg.layer_decay < 1.0:
            scales = layer_decay_scales(params, cfg.layer_decay, self.encoder_depth,
                                        self.decoder_layers)
            u = torch._foreach_mul(u, [scales[n] for n in names])

        # optax.scale_by_learning_rate: the schedule reads the count BEFORE
        # this update (0 on the first one)
        lr = self.schedule(state["count"]).to(p[0].device)
        u = torch._foreach_mul(u, -lr)
        return dict(zip(names, u)), new_state

    def fused_tables(self, params: Params) -> Tuple[List[bool], List[float]]:
        """Per leaf of ``params``, in order: whether the fused update adds
        ``weight_decay * p`` and its layer-decay scale; the chain's own
        :func:`default_weight_decay_mask` and :func:`layer_decay_scales`."""
        names = list(params)
        mask = default_weight_decay_mask(params)
        decays = self.name == "adamw" and bool(self.cfg.weight_decay)
        flags = [decays and mask[n] for n in names]
        layer_decay = self.cfg.layer_decay
        if layer_decay is None or layer_decay >= 1.0:
            return flags, [1.0] * len(names)
        scales = layer_decay_scales(params, layer_decay, self.encoder_depth, self.decoder_layers)
        return flags, [scales[n] for n in names]

    @torch.no_grad()
    def fused_update(self, params: Params, grads: List[torch.Tensor], state: Dict,
                     loss: torch.Tensor, skip_nonfinite: bool = True) -> Dict[str, torch.Tensor]:
        """One step of the chain by :func:`~pixparse_tpu_torch.ops.optimizer.fused_adamw`
        (``adam`` / ``adamw``, clip ``None`` or ``norm``; see
        :func:`fused_update_applies`): ``params`` and ``state``'s tensors are
        updated in place, and a non-finite step (``skip_nonfinite``) changes
        none of them. Returns the metrics: ``loss``, ``grad_norm`` and, with
        the skip, ``nonfinite``. The per-leaf tables are built on the first
        call and kept while the leaves stay where they are."""
        names = list(params)
        p = list(params.values())
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        plan = self._fused_plan
        if plan is None or not plan.serves(names, p, mu, nu):
            plan = self._fused_plan = FusedAdamWPlan(names, p, mu, nu, *self.fused_tables(params))
        # optax.scale_by_learning_rate: the schedule reads the count before
        # this update
        lr = self.schedule(state["count"])
        grad_norm, nonfinite = fused_adamw(
            plan, grads, state["count"], lr, loss, betas=self.betas, eps=self.cfg.eps,
            weight_decay=self.cfg.weight_decay,
            max_norm=self.cfg.clip_grad_value if self.clip_mode == "norm" else None,
            skip_nonfinite=skip_nonfinite)
        metrics = dict(loss=loss, grad_norm=grad_norm)
        if skip_nonfinite:
            metrics["nonfinite"] = nonfinite
        return metrics


def fused_update_applies(optimizer: Optimizer, device: torch.device, shards=None) -> bool:
    """Whether the train step takes :meth:`Optimizer.fused_update` over
    tensors on ``device``: CUDA tensors of one process (no ``shards``),
    optimizer ``adam`` or ``adamw``, clip ``None`` or ``norm``. Every other
    case takes the chain (:meth:`Optimizer.update`)."""
    return (device.type == "cuda" and shards is None and optimizer.name in ("adam", "adamw")
            and optimizer.clip_mode in (None, "norm"))


def create_optimizer(
    cfg: OptimizationCfg,
    num_intervals: int,
    num_warmup_intervals: int,
    updates_per_interval: int,
    encoder_depth: int = 0,
    decoder_layers: int = 0,
) -> Tuple[Optimizer, Schedule]:
    """OptimizationCfg -> ``(optimizer, lr schedule)``. Gradient accumulation
    is the train step's business
    (:func:`pixparse_tpu_torch.framework.train_state.make_train_step`), as in
    the JAX package's ``wrap_multisteps=False`` mode."""
    schedule = create_scheduler(cfg, num_intervals, num_warmup_intervals, updates_per_interval)
    return Optimizer(cfg, schedule, encoder_depth, decoder_layers), schedule
