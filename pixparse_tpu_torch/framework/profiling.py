"""Profiling and MFU accounting (counterpart of
:mod:`pixparse_tpu.framework.profiling`).

- :func:`span` and :func:`count`: the program's own host-clock spans and
  counters around host work the device trace cannot name (a batch's
  preparation and copy, the optimizer's host ops, a decode step's flag
  read, detokenization, set-up). Off by default: a span is then one shared
  no-op object and a count does nothing. :func:`collect` turns them on and
  gathers them; under a running profiler each span is also a
  ``pixparse.<name>`` range on the trace's clock. :func:`tally` is a
  counter kept on the device (a tensor summed there while collecting, read
  by the host only after the collected work: :meth:`Collection.read_tallies`);
- :func:`trace`: a ``torch.profiler`` capture context (CPU and CUDA
  activities) that writes a chrome trace into a directory and logs the
  spans and counters it collected;
- analytic matmul-FLOP accounting for the Cruller train step
  (:func:`cruller_train_flops`, ViT or Swin encoder: :func:`swin_encoder_flops`;
  the Moonlight prefix LM: :func:`moonlight_train_flops`)
  and :func:`mfu` against the dense bf16
  tensor-core peak of the card the step runs on.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

_logger = logging.getLogger(__name__)


class SpanRecord(NamedTuple):
    name: str
    start: float  # time.perf_counter() at entry
    end: float  # ... and at exit
    parent: Optional[str]  # the enclosing program span on the same thread
    children_s: float  # seconds its direct child spans cover

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Collection:
    """What one :func:`collect` gathered: ``spans``, the records in the
    order they ended, and ``counts`` by name."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: Dict[str, int] = {}
        self.tallies: Dict[str, torch.Tensor] = {}  # device sums of :func:`tally`

    def read_tallies(self) -> Dict[str, List[int]]:
        """Each tally read to the host (one read each; call after the
        collected work, never inside a step)."""
        return {n: [int(x) for x in t.tolist()] for n, t in self.tallies.items()}

    def totals(self) -> Dict[str, Dict[str, float]]:
        """For each span name: ``count``, ``total_s`` and ``self_s`` (the
        total less the time its child spans cover)."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.spans:
            t = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += r.seconds
            t["self_s"] += r.seconds - r.children_s
        return out

    def summary(self) -> str:
        """One line: each span's count and ms a call (total / self), then
        the counters."""
        spans = ", ".join(
            f"{n} {t['count']} x {1e3 * t['total_s'] / t['count']:.3f}"
            f"/{1e3 * t['self_s'] / t['count']:.3f} ms"
            for n, t in sorted(self.totals().items()))
        counts = ", ".join(f"{n} {v}" for n, v in sorted(self.counts.items()))
        return (f"spans (calls x ms a call, total/self): {spans or 'none'}; "
                f"counts: {counts or 'none'}")


_active: Tuple[Collection, ...] = ()  # the open collect() contexts
_local = threading.local()  # .stack: this thread's open spans


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "into", "parent", "children_s", "start", "_range")

    def __init__(self, name: str, into: Tuple[Collection, ...]):
        self.name = name
        self.into = into
        self.children_s = 0.0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range = None
        if torch.autograd._profiler_enabled():  # a range costs microseconds: only for a trace
            self._range = torch.profiler.record_function(f"pixparse.{self.name}")
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.children_s += end - self.start
        rec = SpanRecord(self.name, self.start, end, parent and parent.name, self.children_s)
        for c in self.into:
            c.spans.append(rec)
        return False


def span(name: str):
    """A context manager timing ``name`` while :func:`collect` is on; else
    the shared no-op."""
    if not _active:
        return _NO_SPAN
    return _Span(name, _active)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while :func:`collect` is on."""
    for c in _active:
        c.counts[name] = c.counts.get(name, 0) + n


def tally(name: str, value) -> None:
    """Add ``value()`` (a device tensor; called only while :func:`collect` is
    on) to the tally ``name`` on the device, with no host read."""
    if not _active:
        return
    v = value()
    for c in _active:
        t = c.tallies.get(name)
        c.tallies[name] = v.clone() if t is None else t.add_(v)


@contextlib.contextmanager
def collect():
    """Turn spans and counters on (for every thread) and yield the
    :class:`Collection` they go to; off again at exit, an exception
    included. Nested collections each get everything inside them."""
    global _active
    c = Collection()
    _active = _active + (c,)
    try:
        yield c
    finally:
        _active = tuple(x for x in _active if x is not c)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace into ``logdir/trace.json`` with
    the program's spans and counters on (their ``pixparse.*`` ranges lie in
    the trace); yields the :class:`Collection` and logs its summary at the
    end. A no-op yielding ``None`` when ``logdir`` is empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, collect() as spans:
        yield spans
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    _logger.info("profiler trace written to %s", logdir)
    _logger.info("program %s", spans.summary())


# dense bf16 tensor-core peak FLOP/s by substring of the CUDA device name
# (NVIDIA data sheets, without sparsity)
_PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H200", 989e12),
    ("H100", 989e12),
    ("A100", 312e12),
)


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak of the CUDA device (``None`` on the CPU or an unknown card)."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    return None


def transformer_layer_flops(L: int, D: int, F: int, cross_Lk: int = 0) -> float:
    """Forward matmul FLOPs for one transformer layer at sequence length L:
    self-attention projections, score and value products, FFN (and
    cross-attention when ``cross_Lk`` > 0)."""
    self_attn = 8 * L * D * D + 4 * L * L * D
    ffn = 4 * L * D * F
    cross = 0.0
    if cross_Lk:
        cross = 4 * L * D * D + 4 * cross_Lk * D * D + 4 * L * cross_Lk * D
    return float(self_attn + ffn + cross)


def swin_encoder_flops(cfg) -> float:
    """Forward matmul FLOPs of a Swin encoder: per-stage resolutions and
    widths, WINDOWED attention (the score and value products are N * w^2, not
    N^2), patch merging between stages."""
    gh = cfg.img_size[0] // cfg.patch_size
    gw = cfg.img_size[1] // cfg.patch_size
    w2 = cfg.window_size ** 2
    total = 2 * gh * gw * (cfg.patch_size ** 2 * cfg.in_chans) * cfg.embed_dim
    for stage, depth in enumerate(cfg.depths):
        N = (gh // (2 ** stage)) * (gw // (2 ** stage))
        D = cfg.embed_dim * (2 ** stage)
        per_block = (
            8 * N * D * D  # qkv + out projections
            + 4 * N * w2 * D  # windowed score + value products
            + 4 * N * D * int(D * cfg.mlp_ratio)  # FFN
        )
        total += depth * per_block
        if stage < len(cfg.depths) - 1:
            total += 2 * (N // 4) * (4 * D) * (2 * D)  # patch merging
    return float(total)


def moonlight_layer_flops(cfg, L: int, moe: bool) -> float:
    """Forward matmul FLOPs of one Moonlight decoder layer at length L:
    the MLA projections, its score and value products over the full L x L,
    and the dense MLP or the expert layer (router, the k routed experts of
    every token, the shared experts)."""
    D, H = cfg.hidden_size, cfg.num_attention_heads
    qk, v, r = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    attn = 2 * L * (D * H * qk + D * (r + cfg.qk_rope_head_dim) + r * H * (cfg.qk_nope_head_dim + v)
                    + H * v * D)
    attn += 2 * L * L * H * (qk + v)
    if not moe:
        return float(attn + 6 * L * D * cfg.intermediate_size)
    Fe = cfg.moe_intermediate_size
    ffn = 6 * L * D * Fe * (cfg.num_experts_per_tok + cfg.n_shared_experts)
    return float(attn + ffn + 2 * L * D * cfg.n_routed_experts)


def moonlight_train_flops(vit_cfg, dec_cfg, batch_size: int, text_len: int) -> float:
    """Matmul FLOPs for one forward+backward train step of the Moonlight
    prefix LM (backward = 2x forward): the ViT, the projector, the decoder
    layers over the page rows and the text, the untied head over the
    text."""
    N, De, D = vit_cfg.num_tokens, vit_cfg.embed_dim, dec_cfg.hidden_size
    enc = 2 * N * (vit_cfg.patch_size ** 2 * vit_cfg.in_chans) * De
    enc += vit_cfg.depth * transformer_layer_flops(N, De, int(De * vit_cfg.mlp_ratio))
    proj = 2 * N * (De * D + D * D)
    L = N + text_len
    dec = sum(moonlight_layer_flops(dec_cfg, L, i >= dec_cfg.first_k_dense_replace)
              for i in range(dec_cfg.num_hidden_layers))
    head = 2 * text_len * D * dec_cfg.vocab_size
    return 3.0 * batch_size * (enc + proj + dec + head)


def cruller_train_flops(vit_cfg, bart_cfg, batch_size: int, text_len: int) -> float:
    """Matmul FLOPs for one forward+backward Cruller train step (backward =
    2x forward), ViT (full attention) or Swin (windowed) encoder; a
    Moonlight decoder's cfg goes to :func:`moonlight_train_flops`."""
    if hasattr(bart_cfg, "n_routed_experts"):
        return moonlight_train_flops(vit_cfg, bart_cfg, batch_size, text_len)
    N = vit_cfg.num_tokens
    if hasattr(vit_cfg, "depths"):  # SwinCfg
        enc = swin_encoder_flops(vit_cfg)
    else:
        D = vit_cfg.embed_dim
        enc = 2 * N * (vit_cfg.patch_size ** 2 * vit_cfg.in_chans) * D
        enc += vit_cfg.depth * transformer_layer_flops(N, D, int(D * vit_cfg.mlp_ratio))
    Dd = bart_cfg.d_model
    dec = bart_cfg.decoder_layers * transformer_layer_flops(
        text_len, Dd, bart_cfg.decoder_ffn_dim, cross_Lk=N
    )
    dec += 2 * text_len * Dd * bart_cfg.vocab_size  # tied LM head
    return 3.0 * batch_size * (enc + dec)


def mfu(flops_per_step: float, step_time_s: float, n_devices: int = 1,
        device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None off the card."""
    peak = peak_flops_per_device(device)
    if peak is None or step_time_s <= 0:
        return None
    return flops_per_step / step_time_s / (peak * n_devices)
