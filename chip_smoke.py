#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``pixparse_tpu_torch``).

    python3 chip_smoke.py            # all phases, one CUDA card

Phases, each printing one JSON line on stdout (per-case progress goes to
stderr):

1. ``device``: the card (``nvidia-smi`` name and power limit,
   ``torch.cuda.get_device_name``) and the time to build the CUDA kernels
   from ``pixparse_tpu_torch/csrc`` (``ops/_build.py``).
2. ``kernels``: every kernel of the port checked against its plain PyTorch
   version on the card at the serving path's shapes plus edge cases
   (causal, ``kv_lens`` with an empty row, a multi-tile key length, ragged
   and fully masked decode rows, fp32), and timed with CUDA events (median
   of 25 launches, L2 flushed before each) beside its plain version, one
   ``torch.nn.functional.scaled_dot_product_attention`` call on the same
   inputs (a yardstick only; the port never calls it) and its bound.
   Tolerance, on every element, ``|kernel - plain| <= atol + rtol*|plain|``:
   1e-2/1e-2 in bf16 (outputs round to 8 mantissa bits and the kernels sum
   in another order), 1e-4/1e-4 in fp32; lse 1e-3/1e-4.
3. ``serve_model``: the port's ``Cruller`` at cruller_base width
   (vocab 50265, bf16, seeded random weights) encodes 16 synthetic pages
   and greedily decodes a fixed budget of tokens; asserts 12 flash launches
   per encode and 8 decode-attention launches per decode step, and that the
   flash encoder matches the plain-attention encoder within 5e-2/5e-2
   (12 bf16 layers, each rounding its activations).
4. ``serve_task``: the serving entry point, ``TaskCrullerEvalOCR
   .generate_text``, at ``model_name=cruller_base`` with the pure-Python
   byte-level tokenizer, bf16, on 16 pages already at 576x448. This is the
   main-path run: every kernel counter is zeroed just before it and read
   just after, and each kernel must have launched.

Then the ``kernels`` summary line (launch counts from the main-path run),
the ``nvidia-smi`` name/power-limit line, and the final
``{"ok": true, "device": {...}}`` line. Any failure exits non-zero before
that line. Without CUDA, or without the package beside this script, it
exits non-zero and prints no result. Longer records go to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
PHASES = ("device", "kernels", "serve_model", "serve_task")
MODEL_NEW_TOKENS = 128  # serve_model: fixed decode budget (EOS disabled)
TASK_NEW_TOKENS = 64  # serve_task: generation cap after the one-token prompt

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, fp32
# non-tensor FLOP/s, HBM bytes/s. Matched on the nvidia-smi name.
PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H200": (989e12, 67e12, 4.8e12),
    "H100": (989e12, 67e12, 3.35e12),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def note(obj):
    """Progress record on stderr (stdout carries one line per phase)."""
    print(json.dumps(obj), file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"no published peaks for card {name!r}")


class Timer:
    """CUDA-event timing of single launches with the L2 cache flushed before
    each (the decode loop finds its caches cold: 8 caches per step exceed
    the 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def median_ms(self, fn, n=25, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def close(out, ref, atol, rtol):
    """(max abs error, all within atol + rtol*|ref|)."""
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = (1e-3, 1e-4)


def flash_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("encode_b16_l1009", 16, 1009, 1009, 12, 64, bf, False, None),
        ("causal_256", 4, 256, 256, 12, 64, bf, True, None),
        ("causal_lq100_lk300_d128", 2, 100, 300, 4, 128, bf, True, None),
        ("kv_lens_with_empty_row", 4, 300, 300, 12, 64, bf, False, [300, 0, 17, 129]),
        ("multi_tile_lk2509", 2, 2509, 2509, 12, 64, bf, False, None),
        ("test_width_d32", 3, 77, 77, 2, 32, bf, False, None),
        ("fp32_b2_l333", 2, 333, 333, 12, 64, f32, False, None),
    ]


def decode_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    self_pad = -(-(1 + TASK_NEW_TOKENS) // 128) * 128  # the main path's self cache
    # name, B, Lk, n_valid (None = ragged self-cache mask), H, D, dtype
    return [
        ("cross_b16_lk1024_valid1009", 16, 1024, 1009, 12, 64, bf),
        (f"self_b16_lk{self_pad}_valid{self_pad // 2}", 16, self_pad, self_pad // 2, 12, 64, bf),
        ("self_ragged_with_dead_row", 16, 1024, None, 12, 64, bf),
        ("test_width_d32", 3, 256, None, 2, 32, bf),
        ("fp32_b4_lk333", 4, 384, 333, 12, 64, f32),
    ]


def ragged_mask(torch, B, Lk, gen):
    """Self-cache pattern: a prefix of written keys with pad holes; row 1 is
    fully masked."""
    mask = torch.zeros(B, Lk, dtype=torch.bool)
    for b in range(B):
        n = 0 if b == 1 else int(torch.randint(1, Lk + 1, (1,), generator=gen))
        mask[b, :n] = True
        if n > 8:
            holes = torch.randint(0, n, (max(1, n // 10),), generator=gen)
            mask[b, holes] = False
    return mask


def phase_kernels(torch, F, card_name, timer):
    from pixparse_tpu_torch.ops import flash_attention as fa
    from pixparse_tpu_torch.ops import decode_attention as da

    peak_bf16, peak_f32, bw = peaks_for(card_name)
    gen = torch.Generator().manual_seed(0)
    results = {"flash_attention_fwd": [], "decode_attention": []}
    failed = []

    for name, B, Lq, Lk, H, D, dt, causal, lens in flash_cases(torch):
        # q/k/v as strided views of one fused projection, like the ViT's
        qkv = torch.randn(B, Lq, 3, H, D, generator=gen).to("cuda", dt)
        q = qkv[:, :, 0]
        if Lk == Lq:
            k, v = qkv[:, :, 1], qkv[:, :, 2]
        else:
            kv = torch.randn(B, Lk, 2, H, D, generator=gen).to("cuda", dt)
            k, v = kv[:, :, 0], kv[:, :, 1]
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)
        atol, rtol = TOL[str(dt).split(".")[-1]]
        err, ok = close(o, o_ref, atol, rtol)
        lse_err, lse_ok = close(lse, lse_ref, *LSE_TOL)
        if lens is not None and 0 in lens:
            row = lens.index(0)
            ok = ok and bool((o[row] == 0).all()) and bool((lse[row] == fa.DEAD_LSE).all())
        rec = dict(case=name, shape=[B, Lq, Lk, H, D], dtype=str(dt), causal=causal,
                   kv_lens=lens, max_abs_err=err, lse_max_abs_err=lse_err,
                   tol=[atol, rtol], ok=ok and lse_ok)
        # work this run's inputs need: visible (query, key) pairs, valid keys
        kl = lens or [Lk] * B
        pairs = 0
        for b in range(B):
            n = min(kl[b], Lk)
            if causal:
                pairs += sum(max(0, min(n, i + (Lk - Lq) + 1)) for i in range(Lq))
            else:
                pairs += Lq * n
        flops = 4.0 * H * D * pairs
        elt = q.element_size()
        nbytes = elt * H * D * (2 * B * Lq + 2 * sum(min(n, Lk) for n in kl)) + 4 * B * H * Lq
        t_ops = flops / (peak_bf16 if dt == torch.bfloat16 else peak_f32)
        t_mem = nbytes / bw
        rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
                   bound_by="operations" if t_ops >= t_mem else "bytes")
        rec["ms"] = timer.median_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens))
        rec["plain_ms"] = timer.median_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if kv_lens is not None:
            am = (torch.arange(Lk, device="cuda")[None] < kv_lens[:, None])[:, None, None, :]
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        rec["library_ms"] = timer.median_ms(lib)
        results["flash_attention_fwd"].append(rec)
        note({"kernel": "flash_attention_fwd", **rec})
        if not rec["ok"]:
            failed.append(f"flash_attention_fwd/{name}")
        del qkv, q, k, v, o, lse, o_ref, lse_ref

    for name, B, Lk, n_valid, H, D, dt in decode_cases(torch):
        HD = H * D
        q = torch.randn(B, 1, HD, generator=gen).to("cuda", dt)
        k = torch.randn(B, Lk, HD, generator=gen).to("cuda", dt)
        v = torch.randn(B, Lk, HD, generator=gen).to("cuda", dt)
        if n_valid is None:
            mask = ragged_mask(torch, B, Lk, gen).cuda()
        else:
            mask = (torch.arange(Lk) < n_valid)[None].expand(B, Lk).contiguous().cuda()
        o = da.decode_attention(q, k, v, mask, num_heads=H)
        torch.cuda.synchronize()
        o_ref = da.decode_attention_plain(q, k, v, mask, num_heads=H)
        atol, rtol = TOL[str(dt).split(".")[-1]]
        err, ok = close(o, o_ref, atol, rtol)
        dead = ~mask.any(dim=1)
        if bool(dead.any()):
            ok = ok and bool((o[dead] == 0).all())
        rec = dict(case=name, shape=[B, Lk, H, D], dtype=str(dt), max_abs_err=err,
                   tol=[atol, rtol], ok=ok, valid_keys=int(mask.sum()))
        elt = q.element_size()
        nvk = int(mask.sum())
        flops = 4.0 * D * H * nvk
        nbytes = elt * (2 * B * HD + 2 * nvk * HD) + B * Lk
        t_ops = flops / (peak_bf16 if dt == torch.bfloat16 else peak_f32)
        t_mem = nbytes / bw
        rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
                   bound_by="operations" if t_ops >= t_mem else "bytes")
        rec["ms"] = timer.median_ms(lambda: da.decode_attention(q, k, v, mask, num_heads=H))
        rec["plain_ms"] = timer.median_ms(
            lambda: da.decode_attention_plain(q, k, v, mask, num_heads=H))
        qt = q.view(B, 1, H, D).transpose(1, 2)
        kt = k.view(B, Lk, H, D).transpose(1, 2)
        vt = v.view(B, Lk, H, D).transpose(1, 2)
        am = mask[:, None, None, :]
        rec["library_ms"] = timer.median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am))
        results["decode_attention"].append(rec)
        note({"kernel": "decode_attention", **rec})
        if not rec["ok"]:
            failed.append(f"decode_attention/{name}")
        del q, k, v, o, o_ref
    emit({"phase": "kernels", "cases": results})
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return results


KERNELS = [
    # name, route, source, replaces (TPU kernel: file:line), main-path case
    ("flash_attention_fwd", "cuda", "pixparse_tpu_torch/csrc/flash_attention.cu",
     "pixparse_tpu/ops/flash_attention.py:129 (_fwd_kernel_single), :183 (_fwd_kernel)",
     "encode_b16_l1009"),
    ("decode_attention", "cuda", "pixparse_tpu_torch/csrc/decode_attention.cu",
     "pixparse_tpu/ops/decode_attention.py:62 (_decode_attn_kernel)",
     "cross_b16_lk1024_valid1009"),
]


def counters():
    from pixparse_tpu_torch.ops.decode_attention import decode_attention
    from pixparse_tpu_torch.ops.flash_attention import flash_attention_fwd

    return {"flash_attention_fwd": flash_attention_fwd, "decode_attention": decode_attention}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def synthetic_pages(torch, B, H, W, gen):
    """Normalized page-like images (NHWC, 1 channel): light background with
    dark text-line bands, values in the legacy transform's [-1, 1] range."""
    img = torch.ones(B, H, W, 1)
    for b in range(B):
        for y in range(8, H - 16, 24):
            n = int(torch.randint(W // 4, W - 16, (1,), generator=gen))
            img[b, y:y + 12, 8:8 + n] = torch.rand(12, n, 1, generator=gen) * 0.4
    return img * 2.0 - 1.0


def device_profile(torch, fn, tag, wall_ms):
    """``torch.profiler`` over one call of ``fn``: device time by kernel
    (table in ``OUT_DIR/profile_<tag>.txt``), and the device's idle share of
    ``wall_ms``, the same call's time measured without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(torch)
    events = prof.key_averages()
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    return {
        "wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], dev_ms(e), e.count] for e in top],
    }


def cached_vs_parallel(torch, model, enc, ids):
    """Logits of a prefill plus single-token decode steps over ``ids`` (the
    decode-attention kernel on the card) against one teacher-forced parallel
    pass over the same tokens with plain attention (no kernel)."""
    from pixparse_tpu_torch.models.bart import KVCache

    cache = KVCache(max_len=ids.shape[1])
    steps = [model.decode(ids[:, :1], enc, cache, mode="prefill")[:, -1]]
    for t in range(1, ids.shape[1]):
        steps.append(model.decode(ids[:, t:t + 1], enc, cache, mode="decode")[:, -1])
    model.attn_impl = "xla"
    parallel = model.decode(ids, enc, mode="train")
    model.attn_impl = "flash"
    return close(torch.stack(steps, 1), parallel, 5e-2, 5e-2)


def phase_serve_model(torch, new_tokens=MODEL_NEW_TOKENS, B=16, model_name="cruller_base",
                      device="cuda", profile=False):
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
    from pixparse_tpu_torch.ops.generation import generate

    cfg = get_model_config(model_name)
    vit_cfg, bart_cfg, _ = resolve_cruller_cfgs(cfg, vocab_size=50265)
    gen = torch.Generator().manual_seed(0)
    model = Cruller(vit_cfg, bart_cfg, attn_impl="flash").init_weights(gen)
    model = model.to(device, torch.bfloat16).eval()
    images = synthetic_pages(torch, B, *vit_cfg.img_size, gen).to(device)

    with torch.inference_mode():
        enc = model.encode(images)  # warm-up (cuBLAS handles, allocator)
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        enc = model.encode(images)
        sync(torch)
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = read_counts()
        model.attn_impl = "xla"
        enc_plain = model.encode(images)
        model.attn_impl = "flash"
        enc_err, enc_ok = close(enc, enc_plain, 5e-2, 5e-2)

        prompt = torch.zeros(B, 1, dtype=torch.long, device=device)  # <s>
        # eos disabled (-1): every page decodes the whole budget, so the
        # step count and the per-step time are fixed by construction
        kwargs = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1)
        generate(model, enc, prompt, **dict(kwargs, max_length=9))  # warm-up
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        res = generate(model, enc, prompt, **kwargs)
        sync(torch)
        gen_s = time.perf_counter() - t0
        dec_launches = read_counts()
        dec_err, dec_ok = cached_vs_parallel(torch, model, enc, res.tokens[:, :16])
        if profile:
            prof = {
                "encode": device_profile(torch, lambda: model.encode(images), "encode", encode_ms),
                "generate": device_profile(
                    torch, lambda: generate(model, enc, prompt, **kwargs), "generate", gen_s * 1e3),
            }
    steps = res.steps
    rec = {
        "phase": "serve_model", "model": model_name, "batch": B, "dtype": "bfloat16",
        "vocab": bart_cfg.vocab_size, "encoder_tokens": vit_cfg.num_tokens,
        "new_tokens": new_tokens, "decode_steps": steps,
        "encode_launches": enc_launches, "generate_launches": dec_launches,
        "encode_flash_vs_plain_max_abs_err": enc_err, "encode_tol": [5e-2, 5e-2],
        "decode_cached_vs_parallel_max_abs_err": dec_err, "decode_tol": [5e-2, 5e-2],
        "encode_ms": encode_ms, "generate_ms": gen_s * 1e3,
        "decode_ms_per_step": gen_s * 1e3 / max(steps, 1),
        "pages_per_s": B / (encode_ms / 1e3 + gen_s),
        "tokens_per_s": B * new_tokens / gen_s,
        "tokens_shape": list(res.tokens.shape),
    }
    if profile:
        rec["profile"] = prof
    emit(rec)
    problems = []
    if enc_launches["flash_attention_fwd"] != vit_cfg.depth:
        problems.append(f"encode ran {enc_launches['flash_attention_fwd']} flash launches, want {vit_cfg.depth}")
    want = 2 * bart_cfg.decoder_layers * steps
    if dec_launches["decode_attention"] != want or steps != new_tokens - 1:
        problems.append(f"generate ran {dec_launches['decode_attention']} decode launches over {steps} steps, want {want}")
    if dec_launches["flash_attention_fwd"] != 0:
        problems.append("generate launched the flash kernel")
    if not enc_ok:
        problems.append(f"flash encoder differs from plain encoder by {enc_err}")
    if not dec_ok:
        problems.append(f"cached decode logits differ from the parallel pass by {dec_err}")
    if tuple(res.tokens.shape) != (B, 1 + new_tokens) or not bool((res.lengths == 1 + new_tokens).all()):
        problems.append(f"tokens {tuple(res.tokens.shape)} lengths {res.lengths.tolist()}")
    if problems:
        raise SystemExit("serve_model failed: " + "; ".join(problems))
    return rec


def phase_serve_task(torch, new_tokens=TASK_NEW_TOKENS, B=16, model_name="cruller_base", device="cuda"):
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import (
        TaskCrullerEvalOCR,
        TaskCrullerEvalOCRCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerEvalOCRCfg(
        model_name=model_name, tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
        dtype="bfloat16", device=device,
    )
    task = TaskCrullerEvalOCR(cfg, DeviceEnv.initialize(cfg.device))
    task.setup()
    gen = torch.Generator().manual_seed(1)
    H, W = task.vit_cfg.img_size
    # uint8 pages already at the model's size go through the eval transform
    # as they are (no resize, so no PIL on the card machine)
    raw = ((synthetic_pages(torch, B, H, W, gen) + 1.0) * 127.5).round().to(torch.uint8)
    images = [task.prepare_image(raw[b, :, :, 0].numpy()) for b in range(B)]
    import numpy as np

    images = np.stack(images)
    prompt = task.prompt_ids(task.task_start_token, B)
    max_length = prompt.shape[1] + new_tokens
    task.generate_text(images[:2], prompt[:2], max_length=prompt.shape[1] + 4)  # warm-up
    sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    texts = task.generate_text(images, prompt, max_length=max_length)
    sync(torch)
    dt = time.perf_counter() - t0
    launches = read_counts()
    rec = {
        "phase": "serve_task", "task": "cruller_eval_ocr", "model_name": model_name,
        "tokenizer": "pixparse_bytelevel", "vocab": task.vocab_size, "batch": B,
        "max_new_tokens": new_tokens, "seconds": dt, "pages_per_s": B / dt,
        "launches": launches, "n_texts": len(texts),
        "text_chars": [len(t) for t in texts],
    }
    emit(rec)
    if len(texts) != B or not all(isinstance(t, str) for t in texts):
        raise SystemExit(f"serve_task: expected {B} strings, got {texts!r}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"serve_task: main path never launched {missing}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="serve_model: also trace encode and generate with torch.profiler "
                         "(device time by kernel, device idle share)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pixparse_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the pixparse_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
        for stem in _build.SIGNATURES:
            fh.write(f"== {stem}\n{_build.ptxas_log(stem)}\n")
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s})

    timer = Timer(torch)
    results = {}
    if "kernels" in phases:
        results = phase_kernels(torch, F, smi, timer)
    if "serve_model" in phases:
        phase_serve_model(torch, profile=args.profile)
    launches = None
    if "serve_task" in phases:
        launches = phase_serve_task(torch)

    with open(os.path.join(OUT_DIR, "kernel_cases.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    if results:
        line = []
        for name, route, source, replaces, main_case in KERNELS:
            rec = next(r for r in results[name] if r["case"] == main_case)
            line.append({
                "name": name, "route": route, "source": source, "replaces": replaces,
                "launches": None if launches is None else launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            })
        emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
