"""Device time of the int8 decode kernel and the LayerNorm kernels.

``decode_attention_q8`` (#9) at the cruller_base and donut_base cross
caches (B 16, 1024 keys, 1009 valid, 12 heads; B 8, 4864 keys, 4800 valid,
16 heads; bf16 q), and ``layer_norm_bwd`` (#13) and ``layer_norm_fwd``
(#12) at every LayerNorm shape of the donut_base B=2 train step (2560x1920,
text 1535; bf16), on seeded inputs, each timed as ``window_variants`` times
(CUDA events, the L2 flushed and the card kept busy ~0.1 ms before each
call, median of 25). It times the ``pixparse_tpu_torch`` found on the
import path, so an older checkout can be timed by running this file with
that checkout first on the path::

    python -m pixparse_tpu_torch.tools.kernel_times
    PYTHONPATH=<other checkout> python pixparse_tpu_torch/tools/kernel_times.py

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Optional, Sequence

import torch

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops import decode_attention as da
from pixparse_tpu_torch.ops import layer_norm as lnm
from pixparse_tpu_torch.tools.window_variants import _median_ms

# (rows, width): Swin stages 0-3 and the three patch mergings at B=2, then
# the mBART decoder's 2 x 1535 tokens
SHAPES = ((614400, 128), (153600, 256), (153600, 512), (38400, 512), (38400, 1024),
          (9600, 1024), (9600, 2048), (3070, 1024))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rec = {"package": os.path.dirname(os.path.dirname(os.path.abspath(lnm.__file__))),
           "q8_device_ms": {}, "bwd_device_ms": {}, "fwd_device_ms": {}}
    for B, Lk, valid, H in ((16, 1024, 1009, 12), (8, 4864, 4800, 16)):
        gen = torch.Generator(device="cuda").manual_seed(Lk)
        q = torch.randn(B, 1, H * 64, device="cuda", generator=gen).bfloat16()
        (k8, ks), (v8, vs) = (da.quantize_kv_rows(
            torch.randn(B, Lk, H * 64, device="cuda", generator=gen), H) for _ in range(2))
        mask = (torch.arange(Lk, device="cuda") < valid)[None].expand(B, Lk).contiguous()
        rec["q8_device_ms"][f"{B}x{Lk}x{H}"] = _median_ms(
            lambda: da.decode_attention_q8(q, k8, v8, ks, vs, mask, H), flush)
    for R, D in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(R + D)
        x = (torch.randn(R, D, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
        dy = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        w = 1 + 0.3 * torch.randn(D, device="cuda", generator=gen)
        b = 0.2 * torch.randn(D, device="cuda", generator=gen)
        rec["bwd_device_ms"][f"{R}x{D}"] = _median_ms(lambda: lnm.layer_norm_bwd(x, w, dy, 1e-5), flush)
        rec["fwd_device_ms"][f"{R}x{D}"] = _median_ms(lambda: lnm.layer_norm_fwd(x, w, b, 1e-5), flush)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
