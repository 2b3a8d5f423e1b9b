"""Host time per call of the window-attention wrappers against SDPA.

Enqueue only, no synchronisation inside the timed loop: the microseconds the
host spends in ``window_attention`` (forward), ``window_attention_bwd`` and
one ``scaled_dot_product_attention`` call with the same bias + mask, at donut
stage 2 in training (B=2, 384 windows of 100 tokens, C 512, 16 heads,
shifted), median of five loops of 300 calls.

It times the ``pixparse_tpu_torch`` found on the import path, so an older
checkout can be timed by running this file with that checkout first on the
path::

    python -m pixparse_tpu_torch.tools.window_host_time
    PYTHONPATH=<other checkout> python pixparse_tpu_torch/tools/window_host_time.py

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.models.swin import _shift_attn_mask
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops import window_attention as wa


def host_us(fn, n: int = 300, loops: int = 5) -> float:
    out = []
    for _ in range(loops):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.append((t1 - t0) / n * 1e6)
    return statistics.median(out)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    nB, N, C, H = 384, 100, 512, 16
    qkv = torch.randn(nB, N, 3 * C, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(C, -1)
    do = torch.randn(nB, N, C, device="cuda", generator=gen).bfloat16()
    bias = torch.randn(H, N, N, device="cuda", generator=gen)
    mask = torch.from_numpy(_shift_attn_mask(160, 120, 10, 5)).cuda()
    heads = lambda t: t.reshape(nB, N, H, C // H).transpose(1, 2)  # noqa: E731
    attn_mask = (bias[None] + mask.repeat(nB // mask.shape[0], 1, 1)[:, None]).bfloat16()
    rec = {
        "package": os.path.dirname(os.path.dirname(os.path.abspath(wa.__file__))),
        "fwd_wrapper_us": host_us(lambda: wa.window_attention(q, k, v, bias, mask)),
        "bwd_wrapper_us": host_us(lambda: wa.window_attention_bwd(q, k, v, do, bias, mask)),
        "sdpa_us": host_us(lambda: F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=attn_mask)),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
