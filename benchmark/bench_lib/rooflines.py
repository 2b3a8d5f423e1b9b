"""The kernel calls a cell's step makes, from its configuration and batch,
as the bounds of :mod:`bench_lib.bounds` count them, and the roofline share
of a kernel family in a traced sub-window: the summed bounds over the
family's summed device time, in %. A reader returns ``None`` (the metric is
left out) where the family did not run or its wrapper's launches are not
the count the shapes give."""

from __future__ import annotations

from typing import Dict, List, Optional

from bench_lib import bounds
from bench_lib.flops import encoder_tokens
from bench_lib.peaks import peaks_for


def _heads(d: Dict):
    return d["heads"], d["d_model"] // d["heads"]


def flash_train_calls(cfg: Dict, B: int, L: int):
    """(forward calls, backward calls) of one train step: the ViT encoder's
    self-attention, the decoder's causal self-attention and its
    cross-attention over the encoder rows."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    H, D = _heads(dec)
    Lk = encoder_tokens(enc)
    shapes = []
    if enc["kind"] == "vit":
        He = enc["num_heads"]
        shapes += [(B, Lk, Lk, He, enc["embed_dim"] // He, False)] * enc["depth"]
    shapes += [(B, L, L, H, D, True)] * dec["layers"]
    shapes += [(B, L, Lk, H, D, False)] * dec["layers"]
    return ([bounds.flash_fwd(*s) for s in shapes], [bounds.flash_bwd(*s) for s in shapes])


def window_train_calls(cfg: Dict, B: int):
    """(forward calls, backward calls) of the Swin encoder's window
    attention in one train step."""
    enc = cfg["encoder"]
    if enc["kind"] != "swin":
        return [], []
    p = enc["patch_size"]
    gh, gw = enc["image_size"][0] // p, enc["image_size"][1] // p
    fwd, bwd = [], []
    for s, depth in enumerate(enc["depths"]):
        h, w = gh >> s, gw >> s
        win = min(enc["window_size"], h, w)
        hp, wp = -(-h // win) * win, -(-w // win) * win
        nW = (hp // win) * (wp // win)
        C, H = enc["embed_dim"] << s, enc["num_heads"][s]
        for b in range(depth):
            shifted = b % 2 == 1 and win < min(h, w)
            args = (B * nW, win * win, C, H, nW if shifted else 0)
            fwd.append(bounds.window_fwd(*args))
            bwd.append(bounds.window_bwd(*args))
    return fwd, bwd


def share(rec, family: str, calls: List, counters: Dict[str, int]) -> Optional[float]:
    """``calls`` are one step's; the traced sub-window ran
    ``rec.window['trace_steps']`` steps. ``counters``: wrapper name -> the
    launches one step makes."""
    trace = rec.trace
    if not trace or not calls or trace["family_s"].get(family, 0.0) <= 0.0:
        return None
    steps = rec.window["trace_steps"]
    for name, per_step in counters.items():
        if (rec.launches or {}).get(name) != per_step * steps:
            return None
    pk = peaks_for(rec.card)
    if pk is None:
        return None
    bound_s = steps * bounds.seconds(calls, pk.bf16_flops, pk.hbm_bytes)
    return 100.0 * bound_s / trace["family_s"][family]
