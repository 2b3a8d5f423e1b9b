"""Time the bf16 window-attention forward (kernel #14) against edited copies
of its source, in one process on the card.

A variant is the port's ``csrc/`` with text substitutions, built with
``ops/_build.NVCC_FLAGS`` into ``csrc/build/variants/<name>/`` and loaded
beside the tree's own library. Each case times the tree's kernel, every
variant, then the tree's again (CUDA events around one launch, the L2 cache
flushed and the card kept busy ~0.1 ms before each, median of 25), and holds
each variant's output against the plain version (1e-2 + 1e-2·|ref|).

Variants:

- ``producer_combines``: the producer warp adds bias[h] into each mask slot
  between its copies (as the backward does) and there is no combiner warp.

Run on the card::

    python -m pixparse_tpu_torch.tools.window_variants

It prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from typing import Optional, Sequence

import torch

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.models.swin import _shift_attn_mask
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops import window_attention as wa

STEM = "window_attention"
VARIANTS = {
    "producer_combines": [
        ("static constexpr int kThreads = kConsumers + 64;",
         "static constexpr int kThreads = kConsumers + 32;"),
        ("    if (lane == 0) {\n      const CUtensorMap* const maps[3]",
         "    {\n      const CUtensorMap* const maps[3]"),
        ("produce<D, 3, false>", "produce<D, 3, true>"),
    ],
}
# name, images, stage map (h, w), C, H: donut_base at 2560x1920, window 10, shifted
CASES = [
    ("stage0_b8_n100_c128_h4_shifted", 8, (640, 480), 128, 4),
    ("stage2_b8_n100_c512_h16_shifted", 8, (160, 120), 512, 16),
    ("stage0_b2_n100_c128_h4_shifted", 2, (640, 480), 128, 4),
    ("stage2_b2_n100_c512_h16_shifted", 2, (160, 120), 512, 16),
]


def _build_variant(name, subs) -> ctypes.CDLL:
    root = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    src = root / "src"
    shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("build"))
    path = src / f"{STEM}.cu"
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {STEM}.cu")
        text = text.replace(old, new)
    path.write_text(text)
    flags = [str(src) if f == str(_build.CSRC) else f for f in _build.NVCC_FLAGS]
    out = root / f"lib{STEM}.so"
    subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(path)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES[STEM].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _use(lib) -> None:
    _build._libs[STEM] = lib
    wa._config_cached.cache_clear()
    wa._launch_plan.cache_clear()


def _median_ms(fn, flush, n=25) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(200_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    tree = _build.library(STEM)
    libs = {name: _build_variant(name, subs) for name, subs in VARIANTS.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for case, images, (mh, mw), C, H in CASES:
            nB = images * (mh // 10) * (mw // 10)
            qkv = torch.randn(nB, 100, 3 * C, device="cuda", generator=gen).bfloat16()
            q, k, v = qkv.split(C, dim=-1)
            bias = torch.randn(H, 100, 100, device="cuda", generator=gen) * 0.5
            mask = torch.from_numpy(_shift_attn_mask(mh, mw, 10, 5)).cuda()
            ref = wa.window_attention_plain(q, k, v, bias, mask).float()
            row = {"case": case}
            for name, lib in [("tree", tree), *libs.items(), ("tree_again", tree)]:
                _use(lib)
                fn = lambda: wa.window_attention(q, k, v, bias, mask)  # noqa: E731
                err = (fn().float() - ref).abs()
                row[f"{name}_ok"] = bool((err <= 1e-2 + 1e-2 * ref.abs()).all())
                row[f"{name}_ms"] = _median_ms(fn, flush)
            print(json.dumps(row), flush=True)
    finally:
        _use(tree)


if __name__ == "__main__":
    main()
