"""Host time per call of the LayerNorm and int8 decode wrappers.

Enqueue only, no synchronisation inside the timed loop (the method of
``window_host_time``): the microseconds the host spends in

- ``layer_norm_bwd`` against one autograd backward through ``F.layer_norm``
  (``torch.autograd.grad``, the graph kept) and ``layer_norm_fwd`` against
  one ``F.layer_norm`` on the same bf16 rows, at the donut_base decoder's
  (3070, 1024) and Swin stage 2's (38400, 512);
- ``decode_attention_q8`` against ``decode_attention`` (bf16) at the
  cruller_base cross cache (B 16, 1024 keys, 12 heads of 64),

median of five loops of 300 calls. It times the ``pixparse_tpu_torch``
found on the import path, so an older checkout can be timed by running
this file with that checkout first on the path::

    python -m pixparse_tpu_torch.tools.wrapper_host_time
    PYTHONPATH=<other checkout> python pixparse_tpu_torch/tools/wrapper_host_time.py

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops import decode_attention as da
from pixparse_tpu_torch.ops import layer_norm as lnm
from pixparse_tpu_torch.tools.window_host_time import host_us


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {"package": os.path.dirname(os.path.dirname(os.path.abspath(lnm.__file__)))}
    for R, D in ((3070, 1024), (38400, 512)):
        x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        dy = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        w, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
        leaves = [t.detach().requires_grad_() for t in (x, w.bfloat16(), b.bfloat16())]
        out = F.layer_norm(leaves[0], (D,), leaves[1], leaves[2], 1e-5)
        rec[f"ln_bwd_wrapper_us_{R}x{D}"] = host_us(lambda: lnm.layer_norm_bwd(x, w, dy, 1e-5))
        rec[f"ln_autograd_us_{R}x{D}"] = host_us(
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))
        rec[f"ln_fwd_wrapper_us_{R}x{D}"] = host_us(lambda: lnm.layer_norm_fwd(x, w, b, 1e-5))
        rec[f"f_layer_norm_us_{R}x{D}"] = host_us(
            lambda: F.layer_norm(x, (D,), leaves[1].detach(), leaves[2].detach(), 1e-5))
    B, Lk, H, D = 16, 1024, 12, 64
    q = torch.randn(B, 1, H * D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, Lk, H * D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, Lk, H * D, device="cuda", generator=gen).bfloat16()
    mask = torch.ones(B, Lk, dtype=torch.bool, device="cuda")
    (k_i8, ks), (v_i8, vs) = da.quantize_kv_rows(k, H), da.quantize_kv_rows(v, H)
    rec["q8_wrapper_us"] = host_us(lambda: da.decode_attention_q8(q, k_i8, v_i8, ks, vs, mask, H))
    rec["bf16_decode_wrapper_us"] = host_us(lambda: da.decode_attention(q, k, v, mask, H))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
