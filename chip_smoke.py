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
   Window attention is held at donut_base's four stage shapes at B=8
   (2560x1920), with and without the shift mask, at the train step's B=2
   (shifted), plus windows 7 and 4 and an fp32 case (its yardstick: SDPA
   with ``attn_mask = bias + mask``), each record with its launch (blocks
   per SM, shared memory, ring stages, mask slots, the plan's runs); the
   int8 decode kernel at the cruller_base and donut_base cross caches and a
   ragged cache with a dead row (its yardsticks: SDPA and the bf16 decode
   kernel on the dequantized caches; the kernel's integer sums are exact, so
   it is held to its plain version within 1e-2/1e-2 in bf16).
   Tolerance, on every element, ``|kernel - plain| <= atol + rtol*|plain|``:
   1e-2/1e-2 in bf16 (outputs round to 8 mantissa bits and the kernels sum
   in another order), 1e-4/1e-4 in fp32; lse 1e-3/1e-4. The flash forward
   is held at all three sites of a train step too (encoder 1009, causal
   decoder self 1023, decoder cross 1023x1009), at the donut_base decoder's
   two (B=2, H=16: causal self 1535, cross 1535x4800 over the Swin tokens)
   and at the edges of the wgmma kernels' tiles (lengths 1, 63, 65, 127,
   129; causal with Lq < Lk across a 128-key boundary; kv_lens on a tile
   boundary and one past it); the flash backward at the same cases. Each
   flash and CE record carries ``ratio_to_library`` (kernel over the library
   call) and ``bound_share`` (bound over kernel). The ``device`` line carries
   the registers, spills and shared memory of the wgmma flash kernels
   (``flash_ptxas``), of the CE backward's three products (``ce_ptxas``), of
   the CE forward's product and merge (``ce_fwd_ptxas``), of the decode
   kernel (``decode_ptxas``) and of the bf16 window kernels at ww 100 and
   head dim 32 (``window_ptxas``), from the build's ``-Xptxas -v`` log.
   Every decode, CE forward and window (forward and backward, dbias
   included) case must give the same bits on a second launch.
   A decode or window record also carries ``device_ms`` and
   ``library_device_ms``: the same timing with the card kept busy for ~0.1
   ms between the flush and the call, so neither the host's enqueue time
   nor the tail of the flush is counted (each can add microseconds to a
   short kernel).
   The training kernels join at the train step's shapes: the flash
   backward (dq, dk, dv) beside autograd
   through ``scaled_dot_product_attention``, and the fused cross entropy
   forward (lse and target logit, 1e-3/1e-4) and backward beside autograd
   through ``F.linear`` + ``F.cross_entropy``. Gradients are held row by row,
   whatever their scale: the L2 error of every row (one token's head for
   dq/dk/dv, one token of dh, one vocabulary entry of dE) within 2e-2 of
   that row's L2 norm in bf16 (p, ds and g round to bf16 before products
   that sum up to 16k terms), 2e-4 in fp32. The CE gradients are tiny (the
   loss is a mean over 16k tokens) and most rows of dE are hundreds of times
   smaller than the target rows; rows whose reference is 0 must be 0. The
   CE backward also runs at one full vocabulary chunk and one row (T 16368,
   V 8193, D 768); every backward case must give the same bits on a second
   launch, and its record carries the call's workspace and fp32 dh
   accumulator bytes and its peak memory over its inputs. A
   flash-gradient row whose true value is 0 (a causal query that sees one
   key) carries fp32 cancellation noise in kernel and plain version alike,
   so rows under 1% of the tensor's mean row norm are held to 2e-2 of that
   1% instead. The probe tools' kernels join at the tools' full sizes: the
   MXU probe's three variants (M 512, N 256, R 64, G 256; fp32 sums held to
   1e-4 relative, every repeat's slab equal bit for bit; yardstick one
   ``torch.matmul`` on the K-concatenated operands batched over the
   repeats) and the banded window kernel at the probe's smoke, stage 0 and
   stage 2 maps (bf16 1e-2/1e-2, the same bits on a second launch;
   yardstick partition + SDPA with ``attn_mask = bias`` + reverse, three
   calls; beside it kernel #14 on the same windows, partitioned beforehand).
   Both carry ``device_ms``, ``bound_share`` and ``ratio_to_library``, in
   the kernels line too.
3. ``probes``: the probe tools' main paths on the card
   (``pixparse_tpu_torch.tools.mxu_probe`` and ``.window_band_probe all``):
   useful TFLOP/s of the three MXU-probe variants and of ``torch.matmul``;
   per geometry the current window path (partition, kernel #14, reverse)
   against the banded one (kernel #17 on the NHWC map), their max|diff|
   (at most 1e-3) and the two kernels alone; then the two answers on lines
   of their own (``probe_answer``: each variant's useful TFLOP/s and time
   over ``torch.matmul``; banded over current path, #17 over #14). Counters
   zeroed before, read after; each probe kernel must have launched. In the kernels line this
   run's launches are summed for #16 and #17 only (for #14 they stay in
   ``launches_by_path``).
4. ``serve_model``: the port's ``Cruller`` at cruller_base width
   (vocab 50265, bf16, seeded random weights) encodes 16 synthetic pages
   and greedily decodes a fixed budget of tokens; asserts 12 flash launches
   per encode and 8 decode-attention launches per decode step, and that the
   flash encoder matches the plain-attention encoder within 5e-2/5e-2
   (12 bf16 layers, each rounding its activations).
5. ``serve_task``: the serving entry point, ``TaskCrullerEvalOCR
   .generate_text``, at ``model_name=cruller_base`` with the pure-Python
   byte-level tokenizer, bf16, on 16 pages already at 576x448. This is the
   serving main-path run: every kernel counter is zeroed just before it and
   read just after, and each serving kernel must have launched.
6. ``serve_donut``: the port's ``Cruller`` at donut_base as registered
   (Swin-B window 10 on 2560x1920 RGB = 4800 encoder tokens, the 4-layer
   pre-LN mBART decoder, d 1024, vocab 57525), bf16, seeded random weights,
   B=8, 64 new tokens with EOS off; asserts 20 window-attention launches per
   encode and 8 decode-attention launches per step, the window-kernel
   encoder against the plain-window encoder at B=1 within 5e-2/5e-2, and
   cached decode logits against a parallel pass.
7. ``eval_task``: the eval main path, ``framework.eval.evaluate`` over the
   registered ``cruller_eval_ocr`` with an in-memory loader of seeded
   collated batches (no PIL on the card machine): once at donut_base (bf16)
   and once at cruller_base in the int8 decode mode (``kv_cache_dtype`` and
   ``lm_head_dtype`` int8). The tokenizer is the byte-level one padded with
   filler tokens to the published vocabulary (57525, 50265) and saved to a
   directory; all rows of the random tied table but the byte tokens' are
   zeroed so greedy decoding reads out bytes and CER/WER exist. Counters are zeroed before
   and read after each run; each run's kernels must have launched; CER/WER
   must be finite. The int8-vs-bf16 greedy-token agreement on one batch is
   recorded, not gated (random weights make argmax near-ties common).
8. ``train_model``: the port's ``Cruller`` at cruller_base width and depth
   (vocab 50265, fp32 master weights, bf16 forward, decoder dropout 0.1,
   AdamW) takes train steps of ``make_train_step`` on one fixed seeded batch
   of 16: the loss must be finite and fall; each step must launch 20 flash
   forwards, 20 flash backwards, 1 fused-CE forward and 1 fused-CE backward
   (counted in wrapper calls: a CE backward call launches three products per
   vocabulary chunk). Before
   that, at a batch of 2, the first step of the kernel path is held against
   the plain path (plain attention, chunked plain CE) from the same weights
   and dropout masks: loss within 2e-2 relative, gradient norm within 5e-2
   (a bf16 forward and backward through 16 layers, the two paths rounding at
   different places).
9. ``train_task``: the training entry points, ``TaskFactory`` ->
   ``TaskCrullerPretrain`` on the card -> ``train_setup`` ->
   ``train_one_interval`` over an in-memory loader of seeded collated batches
   (the card machine has no PIL, so no tar of PNGs), at cruller_base with the
   byte-level tokenizer padded with filler tokens to bart-base's 50265
   entries (saved to a directory, whose path is the task's tokenizer name:
   the repository holds no bart tokenizer files), with gradient accumulation
   1 and 2; one full-state checkpoint is saved and
   restored. This is the training main-path run: counters zeroed before, read
   after, and each training kernel must have launched.

Then the ``kernels`` summary line (launch counts from the main-path runs),
the ``nvidia-smi`` name/power-limit line, and the final
``{"ok": true, "device": {...}}`` line. Any failure exits non-zero before
that line. Without CUDA, or without the package beside this script, it
exits non-zero and prints no result. Every phase line is kept in
``chiprun_out/chip_smoke/phases.jsonl`` too. Longer records go to
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
PHASES = ("device", "kernels", "probes", "serve_model", "serve_task", "serve_donut",
          "eval_task", "train_model", "train_donut", "train_task")
MODEL_NEW_TOKENS = 128  # serve_model: fixed decode budget (EOS disabled)
TASK_NEW_TOKENS = 64  # serve_task: generation cap after the one-token prompt
TRAIN_STEPS = 6  # train_model: steps on the repeated batch (the first one warms up)
BART_VOCAB = 50265  # cruller_base's published vocabulary (facebook/bart-base)
DONUT_VOCAB = 57525  # donut_base's (its mBART decoder's table)
DONUT_NEW_TOKENS = 64  # serve_donut: fixed decode budget (EOS disabled)
DONUT_TRAIN_STEPS = 3  # train_donut: steps under each remat mode (the first one warms up)
BYTE_IDS = (4, 260)  # the byte-level tokenizer's 256 byte tokens

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, fp32
# non-tensor FLOP/s, HBM bytes/s. Matched on the nvidia-smi name.
PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H200": (989e12, 67e12, 4.8e12),
    "H100": (989e12, 67e12, 3.35e12),
}


def emit(obj):
    """One result line on stdout, kept also in ``phases.jsonl`` (the end of a
    long run's stdout may be all that a caller gets back)."""
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "phases.jsonl"), "a") as fh:
        fh.write(line + "\n")


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

    def median_ms(self, fn, n=25, warmup=3, busy=False):
        """``busy``: the card spins ~0.1 ms after the flush, so the host has
        enqueued ``fn`` and the flush's writes have drained before the
        first event fires: device time alone."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush_buf.zero_()
            if busy:
                torch.cuda._sleep(200_000)
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


def rows_close(out, ref, rtol, floor=0.0):
    """(max abs error, worst row's L2 error over its L2 norm, every row's L2
    error within ``rtol`` of its norm). With ``floor`` 0, rows whose reference
    is 0 must be 0; else a row's norm counts as at least ``floor`` times the
    mean row norm."""
    diff = out.float() - ref.float()
    err = torch_norm(diff)
    scale = torch_norm(ref.float())
    if floor:
        scale = scale.clamp_min(floor * float(scale.mean()))
    rel = (err / scale.clamp_min(1e-30)).masked_fill(scale == 0, 0.0)
    ok = bool((err <= rtol * scale).all())
    return float(diff.abs().max()), float(rel.max()), ok


def torch_norm(x):
    return x.square().sum(dim=-1).sqrt()


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = (1e-3, 1e-4)
BWD_ROW_RTOL = {"bfloat16": 2e-2, "float32": 2e-4}  # flash dq, dk, dv: per (token, head) row
BWD_ROW_FLOOR = 1e-2  # of the mean row norm: rows whose true gradient is 0
CE_ROW_RTOL = 2e-2


def flash_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("encode_b16_l1009", 16, 1009, 1009, 12, 64, bf, False, None),
        ("decoder_self_causal_b16_l1023", 16, 1023, 1023, 12, 64, bf, True, None),
        ("decoder_cross_b16_lq1023_lk1009", 16, 1023, 1009, 12, 64, bf, False, None),
        ("causal_256", 4, 256, 256, 12, 64, bf, True, None),
        ("causal_lq100_lk300_d128", 2, 100, 300, 4, 128, bf, True, None),
        ("kv_lens_with_empty_row", 4, 300, 300, 12, 64, bf, False, [300, 0, 17, 129]),
        ("multi_tile_lk2509", 2, 2509, 2509, 12, 64, bf, False, None),
        ("test_width_d32", 3, 77, 77, 2, 32, bf, False, None),
        ("fp32_b2_l333", 2, 333, 333, 12, 64, f32, False, None),
    ] + flash_new_cases(torch)


def flash_new_cases(torch, backward=False):
    """The donut_base decoder's two sites, and the edges of the wgmma
    kernels' tiles (forward: 128 query rows over 128-key tiles; backward:
    128 own rows over streamed tiles of 64): lengths on and either side of
    64 and 128, causal with Lq < Lk across a 128-key boundary, kv_lens ending
    on a tile boundary and one past it. With a single key p = 1 and the true
    dq, dk are 0 (only cancellation noise is left to compare), so the
    backward takes its one-query edge against 65 keys."""
    bf = torch.bfloat16
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("donut_self_causal_b2_l1535_h16", 2, 1535, 1535, 16, 64, bf, True, None),
        ("donut_cross_b2_lq1535_lk4800_h16", 2, 1535, 4800, 16, 64, bf, False, None),
        ("edge_lq1_lk65", 2, 1, 65, 4, 64, bf, False, None) if backward
        else ("edge_l1", 2, 1, 1, 4, 64, bf, False, None),
        ("edge_l63_causal", 2, 63, 63, 4, 64, bf, True, None),
        ("edge_l65", 2, 65, 65, 4, 64, bf, False, None),
        ("edge_lq127_lk129", 2, 127, 129, 4, 64, bf, False, None),
        ("edge_lq129_lk127_d32", 2, 129, 127, 4, 32, bf, False, None),
        ("edge_l129_causal_d128", 2, 129, 129, 4, 128, bf, True, None),
        ("edge_lq1_lk129_causal", 2, 1, 129, 4, 64, bf, True, None),
        ("causal_lq100_lk200", 2, 100, 200, 4, 64, bf, True, None),
        ("kv_lens_on_tile_boundary", 3, 300, 300, 4, 64, bf, False, [128, 129, 256]),
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
        ("donut_cross_b8_lk4864_valid4800", 8, 4864, 4800, 16, 64, bf),
        # Lk not a multiple of the kernel's 10-key tile (H*D = 768), row 1 dead
        ("ragged_lk997_dead_row", 16, 997, None, 12, 64, bf),
    ]


def window_cases(torch):
    """donut_base's four stages at B=8, 2560x1920 (window 10, maps 640x480
    down to 80x60), shifted (masked) and not; the four stages at the train
    step's B=2, shifted; stage 0 at B=1, shifted (one image per window
    position, as ``app.infer --batch_size 1``); windows 7 and 4; fp32."""
    bf, f32 = torch.bfloat16, torch.float32
    # name, images, map (h, w), window, C, H, shifted, dtype
    cases = []
    for stage, (C, H) in enumerate(((128, 4), (256, 8), (512, 16), (1024, 32))):
        hw = (640 >> stage, 480 >> stage)
        for shifted in (True, False):
            tag = "shifted" if shifted else "unshifted"
            cases.append((f"stage{stage}_b8_n100_c{C}_h{H}_{tag}", 8, hw, 10, C, H, shifted, bf))
    for stage, (C, H) in enumerate(((128, 4), (256, 8), (512, 16), (1024, 32))):
        hw = (640 >> stage, 480 >> stage)
        cases.append((f"stage{stage}_b2_n100_c{C}_h{H}_shifted", 2, hw, 10, C, H, True, bf))
    cases += [
        ("stage0_b1_n100_c128_h4_shifted", 1, (640, 480), 10, 128, 4, True, bf),
        ("window7_b8_n49_c128_h4_shifted", 8, (56, 56), 7, 128, 4, True, bf),
        ("window4_b8_n16_c32_h2_shifted", 8, (16, 16), 4, 32, 2, True, bf),
        ("fp32_b2_n100_c256_h8_shifted", 2, (80, 60), 10, 256, 8, True, f32),
    ]
    return cases


def window_bwd_cases(torch):
    """donut_base's four stages at B=2, 2560x1920 (the train step's shapes),
    shifted and not; windows 7 and 4; fp32."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for stage, (C, H) in enumerate(((128, 4), (256, 8), (512, 16), (1024, 32))):
        hw = (640 >> stage, 480 >> stage)
        for shifted in (True, False):
            tag = "shifted" if shifted else "unshifted"
            cases.append((f"stage{stage}_b2_n100_c{C}_h{H}_{tag}", 2, hw, 10, C, H, shifted, bf))
    cases += [
        ("window7_b2_n49_c128_h4_shifted", 2, (56, 56), 7, 128, 4, True, bf),
        ("window4_b2_n16_c32_h2_shifted", 2, (16, 16), 4, 32, 2, True, bf),
        ("fp32_b2_n100_c256_h8_shifted", 2, (80, 60), 10, 256, 8, True, f32),
    ]
    return cases


def ln_cases(torch):
    """Swin stage 0, stage 2 and the last patch merging at B=2 (2560x1920),
    and the donut decoder's rows (B=2, 1535 tokens, d 1024)."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[-1]
        cases += [
            (f"swin_stage0_r614400_d128_{tag}", 614400, 128, dt),
            (f"swin_stage2_r38400_d512_{tag}", 38400, 512, dt),
            (f"swin_merge3_r9600_d2048_{tag}", 9600, 2048, dt),
            (f"decoder_r3070_d1024_{tag}", 3070, 1024, dt),
        ]
    return cases


def q8_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, B, Lk (cache length), n_valid (None = ragged mask with a dead row), H, D, dtype
    return [
        ("cross_b16_lk1024_valid1009", 16, 1024, 1009, 12, 64, bf),
        ("donut_cross_b8_lk4864_valid4800", 8, 4864, 4800, 16, 64, bf),
        ("ragged_with_dead_row_b16_lk1024", 16, 1024, None, 12, 64, bf),
        ("test_width_d32_b3_lk256", 3, 256, None, 2, 32, bf),
        ("fp32_b4_lk384_valid333", 4, 384, 333, 12, 64, f32),
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


def flash_bwd_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("encoder_b16_l1009", 16, 1009, 1009, 12, 64, bf, False, None),
        ("decoder_self_causal_b16_l1023", 16, 1023, 1023, 12, 64, bf, True, None),
        ("decoder_cross_b16_lq1023_lk1009", 16, 1023, 1009, 12, 64, bf, False, None),
        ("multi_tile_b2_l2509", 2, 2509, 2509, 12, 64, bf, False, None),
        ("kv_lens_with_empty_row", 4, 300, 300, 12, 64, bf, False, [300, 0, 17, 129]),
        ("causal_lq100_lk300_d128", 2, 100, 300, 4, 128, bf, True, None),
        ("test_width_d32", 3, 77, 77, 2, 32, bf, True, None),
        ("fp32_b2_l333", 2, 333, 333, 12, 64, f32, True, None),
    ] + flash_new_cases(torch, backward=True)


def ce_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, T, V, D, dtype, share of ignored tokens
    return [
        ("train_t16368_v50265_d768", 16 * 1023, BART_VOCAB, 768, bf, 0.3),
        # the backward's vocabulary chunks at T 16368 are 8192 rows: one full
        # chunk and one row
        ("chunk_edge_t16368_v8193_d768", 16 * 1023, 8193, 768, bf, 0.3),
        ("all_ignored_t512_v50265_d768", 512, BART_VOCAB, 768, bf, 1.0),
        ("donut_t3070_v57525_d1024", 2 * 1535, DONUT_VOCAB, 1024, bf, 0.3),
        ("test_width_t300_v517_d64", 300, 517, 64, bf, 0.2),
        ("fp32_t200_v1001_d256", 200, 1001, 256, f32, 0.2),
    ]


def visible_pairs(B, Lq, Lk, causal, lens):
    """(query, key) pairs the masks leave, and valid keys per sample."""
    kl = [min(n, Lk) for n in (lens or [Lk] * B)]
    pairs = 0
    for n in kl:
        if causal:
            pairs += sum(max(0, min(n, i + (Lk - Lq) + 1)) for i in range(Lq))
        else:
            pairs += Lq * n
    return pairs, kl


def check_flash_bwd(torch, F, fa, timer, peaks, gen, case):
    name, B, Lq, Lk, H, D, dt, causal, lens = case
    peak_bf16, peak_f32, bw = peaks
    if Lk == Lq:
        q, k, v = torch.randn(B, Lq, 3, H, D, generator=gen).to("cuda", dt).unbind(2)
    else:
        q = torch.randn(B, Lq, H, D, generator=gen).to("cuda", dt)
        k, v = torch.randn(B, Lk, 2, H, D, generator=gen).to("cuda", dt).unbind(2)
    do = torch.randn(B, Lq, H, D, generator=gen).to("cuda", dt)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv_lens)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    got = fa.flash_attention_bwd(*args, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*args, causal=causal, kv_lens=kv_lens)
    rtol = BWD_ROW_RTOL[str(dt).split(".")[-1]]
    errs, row_errs, ref_max, ok = {}, {}, {}, True
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[gname], row_errs[gname], this_ok = rows_close(a, b, rtol, BWD_ROW_FLOOR)
        ref_max[gname] = float(b.float().abs().max())
        ok = ok and this_ok
    if lens is not None and 0 in lens:
        row = lens.index(0)
        ok = ok and all(bool((g[row] == 0).all()) for g in got)
    rec = dict(case=name, shape=[B, Lq, Lk, H, D], dtype=str(dt), causal=causal, kv_lens=lens,
               max_abs_err=max(errs.values()), errs=errs, worst_row_rel_err=row_errs,
               ref_abs_max=ref_max, tol=["row L2", rtol, "floor", BWD_ROW_FLOOR], ok=ok)
    del want
    pairs, kl = visible_pairs(B, Lq, Lk, causal, lens)
    flops = 10.0 * H * D * pairs  # s, dp, dv, dq, dk: five products
    elt = q.element_size()
    nbytes = elt * H * D * (3 * B * Lq + 2 * sum(kl) + 2 * B * Lk) + 8 * B * H * Lq
    t_ops = flops / (peak_bf16 if dt == torch.bfloat16 else peak_f32)
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(
        lambda: fa.flash_attention_bwd(*args, causal=causal, kv_lens=kv_lens), n=15)
    rec["plain_ms"] = timer.median_ms(
        lambda: fa.flash_attention_bwd_plain(*args, causal=causal, kv_lens=kv_lens), n=5, warmup=1)
    # yardstick: the backward of one scaled_dot_product_attention call
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    if kv_lens is not None:
        am = (torch.arange(Lk, device="cuda")[None] < kv_lens[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
    elif causal and Lq != Lk:
        row = torch.arange(Lq, device="cuda")[:, None]
        am = torch.arange(Lk, device="cuda")[None, :] <= row + (Lk - Lq)
        out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
    else:
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    dot = do.transpose(1, 2)
    rec["library_ms"] = timer.median_ms(
        lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True), n=15)
    rec.update(speed_shares(rec))
    return rec


def speed_shares(rec):
    """Kernel time over the library call's, and the bound's share of the
    kernel time (1.0 = at the bound)."""
    return {"ratio_to_library": rec["ms"] / rec["library_ms"],
            "bound_share": rec["bound_ms"] / rec["ms"]}


def check_fused_ce(torch, F, loss, timer, peaks, gen, case):
    """One case -> (forward record, backward record)."""
    name, T, V, D, dt, ignored = case
    peak_bf16, peak_f32, bw = peaks
    peak = peak_bf16 if dt == torch.bfloat16 else peak_f32
    h = (torch.randn(T, D, generator=gen) * 0.5).to("cuda", dt)
    e = (torch.randn(V, D, generator=gen) * 0.2).to("cuda", dt)
    target = torch.randint(0, V, (T,), generator=gen)
    target[torch.rand(T, generator=gen) < ignored] = -1
    target = target.cuda()
    n_valid = int((target >= 0).sum())
    elt = h.element_size()
    common = dict(case=name, shape=[T, V, D], dtype=str(dt), n_valid=n_valid)

    lse, tgt = loss.fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    lse_ref, tgt_ref = loss.fused_ce_fwd_plain(h, e, target)
    lse2, tgt2 = loss.fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    fwd_repeatable = bool(torch.equal(lse, lse2) and torch.equal(tgt, tgt2))
    del lse2, tgt2
    lse_err, lse_ok = close(lse, lse_ref, *LSE_TOL)
    tgt_err, tgt_ok = close(tgt, tgt_ref, *LSE_TOL)
    ok = lse_ok and tgt_ok and fwd_repeatable and bool((tgt[target < 0] == 0).all())
    fwd = dict(common, max_abs_err=max(lse_err, tgt_err), lse_max_abs_err=lse_err,
               tgt_max_abs_err=tgt_err, tol=list(LSE_TOL), repeatable=fwd_repeatable, ok=ok)
    if dt == torch.bfloat16:  # the (max, sum-exp) partials per vocabulary tile
        fwd.update(zip(("vocab_tiles", "partials_bytes"), loss._ce_fwd_plan(T, V)))
    t_ops = 2.0 * T * V * D / peak
    t_mem = (elt * D * (T + V) + 12 * T) / bw
    fwd.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    fwd["ms"] = timer.median_ms(lambda: loss.fused_ce_fwd(h, e, target), n=10)
    fwd["plain_ms"] = timer.median_ms(
        lambda: loss.fused_ce_fwd_plain(h, e, target), n=5, warmup=1)
    lib_t = torch.where(target >= 0, target, -100)
    fwd["library_ms"] = timer.median_ms(
        lambda: F.cross_entropy(F.linear(h, e), lib_t, ignore_index=-100, reduction="sum"), n=10)
    fwd.update(speed_shares(fwd))

    coef = torch.where(target >= 0, 1.0 / max(n_valid, 1), 0.0).float()
    dh, de = loss.fused_ce_bwd(h, e, target, lse_ref, coef)
    torch.cuda.synchronize()
    # a second launch must give the same bits (no atomics); its peak memory
    # over what was allocated before is the call's scratch and outputs
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    dh2, de2 = loss.fused_ce_bwd(h, e, target, lse_ref, coef)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated() - allocated
    repeatable = bool(torch.equal(dh, dh2) and torch.equal(de, de2))
    del dh2, de2
    dh_ref, de_ref = loss.fused_ce_bwd_plain(h, e, target, lse_ref, coef)
    dh_err, dh_rel, dh_ok = rows_close(dh, dh_ref, CE_ROW_RTOL)
    de_err, de_rel, de_ok = rows_close(de, de_ref, CE_ROW_RTOL)
    ok = dh_ok and de_ok and repeatable and bool((dh[target < 0] == 0).all())
    if n_valid == 0:
        ok = ok and bool((dh == 0).all()) and bool((de == 0).all())
    bwd = dict(common, max_abs_err=max(dh_err, de_err), dh_max_abs_err=dh_err,
               de_max_abs_err=de_err, dh_worst_row_rel_err=dh_rel, de_worst_row_rel_err=de_rel,
               ref_abs_max=[float(dh_ref.float().abs().max()), float(de_ref.float().abs().max())],
               tol=["row L2", CE_ROW_RTOL], repeatable=repeatable, ok=ok)
    if dt == torch.bfloat16:  # the (T, Vc) g workspace, and the fp32 dh accumulator
        Vc, chunks, ws_bytes = loss._ce_bwd_plan(T, V, D)
        bwd.update(vocab_chunk=Vc, chunks=len(chunks), workspace_bytes=ws_bytes,
                   dh_acc_bytes=4 * T * D if len(chunks) > 1 else 0)
    bwd["peak_bytes_over_inputs"] = peak_bytes  # scratch + dh + dE
    del dh_ref, de_ref
    t_ops = 6.0 * T * V * D / peak  # the logits again, dh and dE: three products
    t_mem = (2 * elt * D * (T + V) + 12 * T) / bw
    bwd.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    bwd["ms"] = timer.median_ms(lambda: loss.fused_ce_bwd(h, e, target, lse_ref, coef), n=10)
    bwd["plain_ms"] = timer.median_ms(
        lambda: loss.fused_ce_bwd_plain(h, e, target, lse_ref, coef), n=5, warmup=1)
    hl, el = h.detach().requires_grad_(), e.detach().requires_grad_()
    lib_loss = F.cross_entropy(F.linear(hl, el), lib_t, ignore_index=-100, reduction="sum")
    rec_lib = timer.median_ms(
        lambda: torch.autograd.grad(lib_loss, (hl, el), retain_graph=True), n=10)
    bwd["library_ms"] = rec_lib
    bwd.update(speed_shares(bwd))
    return fwd, bwd


def window_launch(wa, direction, q, mask, H, N):
    """The window kernel's launch for these inputs: its configuration (blocks
    per SM, shared memory, ring stages, mask slots) and its plan."""
    import torch

    D = q.shape[-1] // H
    cfg = wa.window_config(direction, q.dtype, N, D, mask is not None, q.device)
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    period = 1 if mask is None else mask.shape[0]
    plan = wa.window_plan(q.shape[0], period, H, N, D, n_sms, cfg["blocks_per_sm"])
    return {"launch": dict(cfg, runs=plan.runs, grid=plan.grid, items_per_head=plan.items)}


def check_window(torch, F, wa, timer, peaks, gen, case):
    from pixparse_tpu_torch.models.swin import _shift_attn_mask

    name, n_img, (mh, mw), window, C, H, shifted, dt = case
    peak_bf16, peak_f32, bw = peaks
    N = window * window
    nW = (mh // window) * (mw // window)
    nB = n_img * nW
    # q/k/v as column slices of one fused projection, as the Swin block reads them
    qkv = torch.randn(nB, N, 3 * C, device="cuda", generator=gen).to(dt)
    q, k, v = qkv.split(C, dim=-1)
    bias = torch.randn(H, N, N, device="cuda", generator=gen) * 0.5
    mask = None
    if shifted:
        mask = torch.from_numpy(_shift_attn_mask(mh, mw, window, window // 2)).cuda()
    o = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(wa.window_attention(q, k, v, bias, mask), o))
    o_ref = wa.window_attention_plain(q, k, v, bias, mask)
    atol, rtol = TOL[str(dt).split(".")[-1]]
    err, ok = close(o, o_ref, atol, rtol)
    rec = dict(case=name, shape=[nB, N, C, H], mask_period=nW if shifted else None,
               dtype=str(dt), max_abs_err=err, tol=[atol, rtol], ok=ok and repeatable,
               repeatable=repeatable, **window_launch(wa, "fwd", q, mask, H, N))
    del o, o_ref
    elt = q.element_size()
    flops = 4.0 * nB * N * N * C  # q k^T and p v
    nbytes = 4 * elt * nB * N * C + 4 * H * N * N + (4 * nW * N * N if shifted else 0)
    t_ops = flops / (peak_bf16 if dt == torch.bfloat16 else peak_f32)
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(lambda: wa.window_attention(q, k, v, bias, mask))
    rec["plain_ms"] = timer.median_ms(
        lambda: wa.window_attention_plain(q, k, v, bias, mask), n=5, warmup=1)
    # yardstick: SDPA with attn_mask = bias + mask, materialised per window
    split = lambda t: t.reshape(nB, N, H, C // H).transpose(1, 2)
    am = bias[None]
    if shifted:
        am = (am + mask.repeat(n_img, 1, 1)[:, None])
    am = am.to(dt)
    lib = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=am)
    rec["library_ms"] = timer.median_ms(lib)
    # the same with the card kept busy while the host enqueues the call
    rec["device_ms"] = timer.median_ms(lambda: wa.window_attention(q, k, v, bias, mask), busy=True)
    rec["library_device_ms"] = timer.median_ms(lib, busy=True)
    del qkv, q, k, v, am
    return rec


def check_window_bwd(torch, F, wa, timer, peaks, gen, case):
    from pixparse_tpu_torch.models.swin import _shift_attn_mask

    name, n_img, (mh, mw), window, C, H, shifted, dt = case
    peak_bf16, peak_f32, bw = peaks
    N = window * window
    nW = (mh // window) * (mw // window)
    nB = n_img * nW
    qkv = torch.randn(nB, N, 3 * C, device="cuda", generator=gen).to(dt)
    q, k, v = qkv.split(C, dim=-1)
    do = torch.randn(nB, N, C, device="cuda", generator=gen).to(dt)
    bias = torch.randn(H, N, N, device="cuda", generator=gen) * 0.5
    mask = None
    if shifted:
        mask = torch.from_numpy(_shift_attn_mask(mh, mw, window, window // 2)).cuda()
    args = (q, k, v, do, bias, mask)
    got = wa.window_attention_bwd(*args)
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, b) for a, b in zip(got, wa.window_attention_bwd(*args)))
    want = wa.window_attention_bwd_plain(*args)
    rtol = BWD_ROW_RTOL[str(dt).split(".")[-1]]
    errs, row_errs, ok = {}, {}, True
    heads = lambda t: t.reshape(nB, N, H, C // H)
    for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if gname != "dbias":
            a, b = heads(a), heads(b)
        errs[gname], row_errs[gname], this_ok = rows_close(a, b, rtol, BWD_ROW_FLOOR)
        ok = ok and this_ok
    rec = dict(case=name, shape=[nB, N, C, H], mask_period=nW if shifted else None,
               dtype=str(dt), max_abs_err=max(errs.values()), errs=errs,
               worst_row_rel_err=row_errs, tol=["row L2", rtol, "floor", BWD_ROW_FLOOR],
               ok=ok and repeatable, repeatable=repeatable,
               **window_launch(wa, "bwd", q, mask, H, N))
    del got, want
    elt = q.element_size()
    flops = 10.0 * nB * N * N * C  # s, dp, dv, dq, dk
    nbytes = 7 * elt * nB * N * C + 8 * H * N * N + (4 * nW * N * N if shifted else 0)
    t_ops = flops / (peak_bf16 if dt == torch.bfloat16 else peak_f32)
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(lambda: wa.window_attention_bwd(*args))
    rec["plain_ms"] = timer.median_ms(lambda: wa.window_attention_bwd_plain(*args), n=5, warmup=1)
    # yardstick: autograd through SDPA with attn_mask = bias + mask per window
    # (its gradient included) where the backend gives one, else through the
    # plain forward
    split = lambda t: t.reshape(nB, N, H, C // H).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    am = bias[None] if mask is None else bias[None] + mask.repeat(n_img, 1, 1)[:, None]
    am = am.expand(nB, H, N, N).to(dt).contiguous().requires_grad_()
    try:
        out = F.scaled_dot_product_attention(*(split(t) for t in leaves), attn_mask=am)
        grads_of = (*leaves, am)
        rec["library"] = "sdpa (attn_mask grad)"
        torch.autograd.grad(out, grads_of, split(do), retain_graph=True)
        dout = split(do)
    except RuntimeError:
        bias_leaf = bias.detach().requires_grad_()
        out = wa.window_attention_plain(*leaves, bias_leaf, mask)
        grads_of = (*leaves, bias_leaf)
        rec["library"] = "autograd through window_attention_plain"
        dout = do
    lib = lambda: torch.autograd.grad(out, grads_of, dout, retain_graph=True)
    rec["library_ms"] = timer.median_ms(lib, n=10)
    rec["device_ms"] = timer.median_ms(lambda: wa.window_attention_bwd(*args), busy=True)
    rec["library_device_ms"] = timer.median_ms(lib, n=10, busy=True)
    del qkv, q, k, v, do, am, out, leaves
    return rec


def check_ln(torch, F, lnm, timer, peaks, gen, case):
    """One case -> (forward record, backward record)."""
    name, R, D, dt = case
    _, _, bw = peaks
    x = (torch.randn(R, D, device="cuda", generator=gen) * 2 + 0.5).to(dt)
    w = 1 + 0.3 * torch.randn(D, device="cuda", generator=gen)
    b = 0.2 * torch.randn(D, device="cuda", generator=gen)
    dy = torch.randn(R, D, device="cuda", generator=gen).to(dt)
    eps = 1e-5
    elt = x.element_size()
    tag = str(dt).split(".")[-1]
    atol, rtol = TOL[tag]
    common = dict(case=name, shape=[R, D], dtype=str(dt))

    y = lnm.layer_norm_fwd(x, w, b, eps)
    torch.cuda.synchronize()
    y_ref = lnm.layer_norm_fwd_plain(x, w, b, eps)
    err, ok = close(y, y_ref, atol, rtol)
    fwd = dict(common, max_abs_err=err, tol=[atol, rtol], ok=ok)
    del y, y_ref
    fwd.update(bound_ms=(2 * elt * R * D + 8 * D) / bw * 1e3, bound_by="bytes")
    fwd["ms"] = timer.median_ms(lambda: lnm.layer_norm_fwd(x, w, b, eps))
    fwd["plain_ms"] = timer.median_ms(lambda: lnm.layer_norm_fwd_plain(x, w, b, eps), n=5, warmup=1)
    wl, bl = w.to(dt), b.to(dt)
    fwd["library_ms"] = timer.median_ms(lambda: F.layer_norm(x, (D,), wl, bl, eps))

    dx, dw, db = lnm.layer_norm_bwd(x, w, dy, eps)
    torch.cuda.synchronize()
    dx_ref, dw_ref, db_ref = lnm.layer_norm_bwd_plain(x, w, dy, eps)
    dx_err, dx_ok = close(dx, dx_ref, atol, rtol)
    # dweight / dbias: sums over R rows, each held as one row (L2 error
    # within rtol of its norm)
    dw_err, dw_rel, dw_ok = rows_close(dw[None], dw_ref[None], rtol)
    db_err, db_rel, db_ok = rows_close(db[None], db_ref[None], rtol)
    bwd = dict(common, max_abs_err=max(dx_err, dw_err, db_err), dx_max_abs_err=dx_err,
               dw_rel_err=dw_rel, db_rel_err=db_rel, tol=[atol, rtol, "dw/db row L2", rtol],
               ok=dx_ok and dw_ok and db_ok)
    del dx, dw, db, dx_ref, dw_ref, db_ref
    bwd.update(bound_ms=(3 * elt * R * D + 12 * D) / bw * 1e3, bound_by="bytes")
    bwd["ms"] = timer.median_ms(lambda: lnm.layer_norm_bwd(x, w, dy, eps))
    bwd["plain_ms"] = timer.median_ms(lambda: lnm.layer_norm_bwd_plain(x, w, dy, eps), n=5, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (x, wl, bl)]
    out = F.layer_norm(leaves[0], (D,), leaves[1], leaves[2], eps)
    bwd["library_ms"] = timer.median_ms(
        lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))
    return fwd, bwd


def check_q8(torch, F, da, timer, peaks, gen, case):
    name, B, Lk, n_valid, H, D, dt = case
    peak_bf16, peak_f32, bw = peaks
    HD = H * D
    q = torch.randn(B, 1, HD, generator=gen).to("cuda", dt)
    if n_valid is None:
        mask = ragged_mask(torch, B, Lk, gen)
    else:
        mask = (torch.arange(Lk) < n_valid)[None].expand(B, Lk).contiguous()
    caches = []
    for _ in range(2):
        # keys past the encoder length are zero, as prefill pads the cache
        x = torch.randn(B, Lk, HD, generator=gen).to("cuda", torch.bfloat16)
        if n_valid is not None:
            x[:, n_valid:] = 0
        caches.append(da.quantize_kv_rows(x, H))
    (k_i8, ks), (v_i8, vs) = caches
    mask = mask.cuda()
    args = (q, k_i8, v_i8, ks, vs, mask)
    o = da.decode_attention_q8(*args, num_heads=H)
    torch.cuda.synchronize()
    o_ref = da.decode_attention_q8_plain(*args, num_heads=H)
    err, ok = close(o, o_ref, 1e-2, 1e-2)
    dead = ~mask.any(dim=1)
    if bool(dead.any()):
        ok = ok and bool((o[dead] == 0).all())
    nvk = int(mask.sum())
    rec = dict(case=name, shape=[B, Lk, H, D], dtype=str(dt), max_abs_err=err,
               tol=[1e-2, 1e-2], ok=ok, valid_keys=nvk)
    elt = q.element_size()
    # int8 K and V rows and their two fp32 scales per valid key, q, o, mask
    nbytes = 2 * nvk * HD + 8 * nvk * H + 2 * elt * B * HD + B * Lk
    t_ops = 4.0 * D * H * nvk / (2 * peak_bf16)  # the int8 tensor rate is twice bf16's
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(lambda: da.decode_attention_q8(*args, num_heads=H))
    rec["plain_ms"] = timer.median_ms(lambda: da.decode_attention_q8_plain(*args, num_heads=H))
    # yardsticks on the dequantized caches: SDPA and the bf16 decode kernel
    deq = [(c.float().view(B, Lk, H, D) * sc.transpose(1, 2)[..., None]).to(dt)
           for c, sc in ((k_i8, ks), (v_i8, vs))]
    qt = q.view(B, 1, H, D).transpose(1, 2)
    kt, vt = (t.transpose(1, 2) for t in deq)
    am = mask[:, None, None, :]
    rec["library_ms"] = timer.median_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am))
    kf, vf = (t.reshape(B, Lk, HD) for t in deq)
    rec["bf16_kernel_ms"] = timer.median_ms(lambda: da.decode_attention(q, kf, vf, mask, num_heads=H))
    return rec


MXU_RTOL = 1e-4  # fp32 sums of 8192 positive products, in another order


def mxu_cases():
    """The MXU probe's three variants at its full size (M 512, N 256, R 64,
    G 256)."""
    from pixparse_tpu_torch.tools import mxu_probe as mp

    return [(f"{v}_m{mp.M}_n{mp.N}_r{mp.R}_g{mp.G}", v) for v in mp.VARIANTS]


def check_mxu(torch, mp, timer, peaks, case):
    name, variant = case
    peak_bf16, _, bw = peaks
    a, b = mp.operands(variant, "cuda")
    out = mp.mxu_dots(a, b, variant)
    torch.cuda.synchronize()
    ref = mp.mxu_dots_plain(a, b, variant)
    err, ok = close(out[0], ref, 0.0, MXU_RTOL)
    same = bool((out == out[0]).all())  # every repeat's slab, bit for bit
    rec = dict(case=name, shape=[mp.SLABS, mp.M, mp.N, mp.R, mp.G], dtype="bfloat16",
               max_abs_err=err, max_rel_err=float(((out[0] - ref).abs() / ref.abs()).max()),
               tol=[0.0, MXU_RTOL], repeats_identical=same, ok=ok and same,
               blocks_per_sm=mp.blocks_per_sm(variant, "cuda"))
    del out
    # the slices the dots read (each once), and the G slabs written once each
    K = mp.VARIANTS[variant][1]
    nbytes = 2 * mp.SLABS * K * (mp.M + mp.N) + 4 * mp.G * mp.M * mp.N
    t_ops = mp.useful_flop() / peak_bf16
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(lambda: mp.mxu_dots(a, b, variant))
    rec["plain_ms"] = timer.median_ms(lambda: mp.mxu_dots_plain(a, b, variant), n=5, warmup=1)
    # yardstick: one torch.matmul on the K-concatenated operands, batched over the repeats
    a_rep, b_rep = mp.library_operands(a, b, variant)
    rec["library_ms"] = timer.median_ms(lambda: torch.matmul(a_rep, b_rep))
    rec["device_ms"] = timer.median_ms(lambda: mp.mxu_dots(a, b, variant), busy=True)
    rec["library_device_ms"] = timer.median_ms(lambda: torch.matmul(a_rep, b_rep), busy=True)
    rec.update(speed_shares(rec),
               useful_tflops=mp.useful_flop() / (rec["ms"] * 1e-3) / 1e12)
    return rec


def band_cases():
    """The banded probe's geometries (a 1280x960 page's stage grids, B=4,
    and its 20x20 smoke map)."""
    from pixparse_tpu_torch.tools import window_band_probe as wb

    return [(f"{w}_b{B}_{Hp}x{Wp}_c{C}_h{H}", B, Hp, Wp, C, H, win, tbw)
            for w, (_, B, Hp, Wp, C, H, win, tbw, _) in wb.GEOMETRIES.items()]


def check_band(torch, F, wb, wa, timer, peaks, gen, case):
    from pixparse_tpu_torch.models.swin import _window_partition

    name, B, Hp, Wp, C, H, win, tbw = case
    peak_bf16, _, bw = peaks
    ww, Dh = win * win, C // H
    nwh, nww = Hp // win, Wp // win
    nB = B * nwh * nww
    qkv = torch.randn(B, Hp, Wp, 3 * C, device="cuda", generator=gen).to(torch.bfloat16)
    bias = torch.randn(H, ww, ww, device="cuda", generator=gen) * 0.5
    o = wb.banded_attention(qkv, bias, win, tbw)
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(wb.banded_attention(qkv, bias, win, tbw), o))
    o_ref = wb.banded_attention_plain(qkv, bias, win, tbw)
    atol, rtol = TOL["bfloat16"]
    err, ok = close(o, o_ref, atol, rtol)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = wb.band_config(win, Dh, qkv.device)
    plan = wb.band_plan(B, Hp, Wp, win, H, Dh, n_sms, cfg["blocks_per_sm"])
    rec = dict(case=name, shape=[B, Hp, Wp, C, H, win, tbw], windows=nB, dtype="torch.bfloat16",
               max_abs_err=err, tol=[atol, rtol], ok=ok and repeatable, repeatable=repeatable,
               launch=dict(cfg, runs=plan.runs, grid=plan.grid))
    del o, o_ref
    nbytes = 2 * qkv.numel() + 2 * B * Hp * Wp * C + 4 * bias.numel()  # qkv, o, bias once
    t_ops = 4.0 * nB * ww * ww * C / peak_bf16
    t_mem = nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(lambda: wb.banded_attention(qkv, bias, win, tbw))
    rec["plain_ms"] = timer.median_ms(
        lambda: wb.banded_attention_plain(qkv, bias, win, tbw), n=5, warmup=1)
    # yardstick, three PyTorch calls: partition into (3, windows, heads, ww, Dh),
    # SDPA with attn_mask = bias, reverse to NHWC
    am = bias[None].to(torch.bfloat16)

    def library():
        qkv_w = qkv.reshape(B, nwh, win, nww, win, 3, H, Dh).permute(5, 0, 1, 3, 6, 2, 4, 7)
        q, k, v = qkv_w.reshape(3, nB, H, ww, Dh).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        return o.reshape(B, nwh, nww, H, win, win, Dh).permute(0, 1, 4, 2, 5, 3, 6).reshape(
            B, Hp, Wp, C)

    # recorded, not gated: the yardstick computes the same function (bias rounded to bf16)
    rec["library_max_abs_err"] = close(library(), wb.banded_attention_plain(qkv, bias, win, tbw),
                                       atol, rtol)[0]
    rec["library_ms"] = timer.median_ms(library)
    rec["device_ms"] = timer.median_ms(lambda: wb.banded_attention(qkv, bias, win, tbw), busy=True)
    rec["library_device_ms"] = timer.median_ms(library, busy=True)
    # kernel #14 on the same windows, partitioned beforehand (the probe's
    # question is what the partition and reverse copies cost beside it)
    q, k, v = _window_partition(qkv, win).split(C, dim=-1)
    rec["window_kernel_ms"] = timer.median_ms(lambda: wa.window_attention(q, k, v, bias))
    rec["window_kernel_device_ms"] = timer.median_ms(
        lambda: wa.window_attention(q, k, v, bias), busy=True)
    rec.update(speed_shares(rec),
               device_ratio_to_window_kernel=rec["device_ms"] / rec["window_kernel_device_ms"],
               device_ratio_to_library=rec["device_ms"] / rec["library_device_ms"])
    del qkv, q, k, v
    return rec


def phase_kernels(torch, F, card_name, timer):
    from pixparse_tpu_torch.ops import flash_attention as fa
    from pixparse_tpu_torch.ops import decode_attention as da
    from pixparse_tpu_torch.ops import layer_norm as lnm
    from pixparse_tpu_torch.ops import loss
    from pixparse_tpu_torch.ops import window_attention as wa
    from pixparse_tpu_torch.tools import mxu_probe as mp
    from pixparse_tpu_torch.tools import window_band_probe as wb

    peaks = peaks_for(card_name)
    peak_bf16, peak_f32, bw = peaks
    gen = torch.Generator().manual_seed(0)
    results = {"flash_attention_fwd": [], "decode_attention": [], "flash_attention_bwd": [],
               "fused_ce_fwd": [], "fused_ce_bwd": [], "window_attention": [],
               "decode_attention_q8": [], "window_attention_bwd": [], "layer_norm_fwd": [],
               "layer_norm_bwd": [], "mxu_dots": [], "banded_attention": []}
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
        pairs, kl = visible_pairs(B, Lq, Lk, causal, lens)
        flops = 4.0 * H * D * pairs
        elt = q.element_size()
        nbytes = elt * H * D * (2 * B * Lq + 2 * sum(kl)) + 4 * B * H * Lq
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
        elif causal and Lq != Lk:  # bottom-right aligned, as the kernel's
            row = torch.arange(Lq, device="cuda")[:, None]
            am = torch.arange(Lk, device="cuda")[None, :] <= row + (Lk - Lq)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        rec["library_ms"] = timer.median_ms(lib)
        rec.update(speed_shares(rec))
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
        repeatable = bool(torch.equal(da.decode_attention(q, k, v, mask, num_heads=H), o))
        o_ref = da.decode_attention_plain(q, k, v, mask, num_heads=H)
        atol, rtol = TOL[str(dt).split(".")[-1]]
        err, ok = close(o, o_ref, atol, rtol)
        dead = ~mask.any(dim=1)
        if bool(dead.any()):
            ok = ok and bool((o[dead] == 0).all())
        elt = q.element_size()
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = da.decode_plan(B, Lk, HD * elt, n_sm)
        rec = dict(case=name, shape=[B, Lk, H, D], dtype=str(dt), max_abs_err=err,
                   tol=[atol, rtol], ok=ok and repeatable, repeatable=repeatable,
                   valid_keys=int(mask.sum()), dead_rows=int(dead.sum()),
                   plan_kt_split_keys_n_split=list(plan),
                   dynamic_smem_bytes=decode_dynamic_smem(plan[0], HD, H, plan[1], elt))
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
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        rec["library_ms"] = timer.median_ms(lib)
        rec.update(speed_shares(rec))
        # the same with the card kept busy between the flush and the call
        rec["device_ms"] = timer.median_ms(
            lambda: da.decode_attention(q, k, v, mask, num_heads=H), busy=True)
        rec["library_device_ms"] = timer.median_ms(lib, busy=True)
        results["decode_attention"].append(rec)
        note({"kernel": "decode_attention", **rec})
        if not rec["ok"]:
            failed.append(f"decode_attention/{name}")
        del q, k, v, o, o_ref

    for case in flash_bwd_cases(torch):
        rec = check_flash_bwd(torch, F, fa, timer, peaks, gen, case)
        results["flash_attention_bwd"].append(rec)
        note({"kernel": "flash_attention_bwd", **rec})
        if not rec["ok"]:
            failed.append(f"flash_attention_bwd/{case[0]}")
        torch.cuda.empty_cache()
    for case in ce_cases(torch):
        fwd, bwd = check_fused_ce(torch, F, loss, timer, peaks, gen, case)
        for kname, rec in (("fused_ce_fwd", fwd), ("fused_ce_bwd", bwd)):
            results[kname].append(rec)
            note({"kernel": kname, **rec})
            if not rec["ok"]:
                failed.append(f"{kname}/{case[0]}")
        torch.cuda.empty_cache()
    cuda_gen = torch.Generator(device="cuda").manual_seed(0)
    for case in window_cases(torch):
        rec = check_window(torch, F, wa, timer, peaks, cuda_gen, case)
        results["window_attention"].append(rec)
        note({"kernel": "window_attention", **rec})
        if not rec["ok"]:
            failed.append(f"window_attention/{case[0]}")
        torch.cuda.empty_cache()
    for case in window_bwd_cases(torch):
        rec = check_window_bwd(torch, F, wa, timer, peaks, cuda_gen, case)
        results["window_attention_bwd"].append(rec)
        note({"kernel": "window_attention_bwd", **rec})
        if not rec["ok"]:
            failed.append(f"window_attention_bwd/{case[0]}")
        torch.cuda.empty_cache()
    for case in ln_cases(torch):
        fwd, bwd = check_ln(torch, F, lnm, timer, peaks, cuda_gen, case)
        for kname, rec in (("layer_norm_fwd", fwd), ("layer_norm_bwd", bwd)):
            results[kname].append(rec)
            note({"kernel": kname, **rec})
            if not rec["ok"]:
                failed.append(f"{kname}/{case[0]}")
        torch.cuda.empty_cache()
    for case in q8_cases(torch):
        rec = check_q8(torch, F, da, timer, peaks, gen, case)
        results["decode_attention_q8"].append(rec)
        note({"kernel": "decode_attention_q8", **rec})
        if not rec["ok"]:
            failed.append(f"decode_attention_q8/{case[0]}")
    for case in mxu_cases():
        rec = check_mxu(torch, mp, timer, peaks, case)
        results["mxu_dots"].append(rec)
        note({"kernel": "mxu_dots", **rec})
        if not rec["ok"]:
            failed.append(f"mxu_dots/{case[0]}")
        torch.cuda.empty_cache()
    for case in band_cases():
        rec = check_band(torch, F, wb, wa, timer, peaks, cuda_gen, case)
        results["banded_attention"].append(rec)
        note({"kernel": "banded_attention", **rec})
        if not rec["ok"]:
            failed.append(f"banded_attention/{case[0]}")
        torch.cuda.empty_cache()
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
    ("flash_attention_bwd", "cuda", "pixparse_tpu_torch/csrc/flash_attention_bwd.cu",
     "pixparse_tpu/ops/flash_attention.py:343 (_bwd_kernel_single), :393 (_bwd_dq_kernel_single), "
     ":435 (_bwd_dkv_kernel_single), :480 (_bwd_dq_kernel), :552 (_bwd_dkv_kernel)",
     "encoder_b16_l1009"),
    ("fused_ce_fwd", "cuda", "pixparse_tpu_torch/csrc/fused_ce.cu",
     "pixparse_tpu/ops/loss.py:141 (_ce_fwd_kernel)", "train_t16368_v50265_d768"),
    ("fused_ce_bwd", "cuda", "pixparse_tpu_torch/csrc/fused_ce.cu",
     "pixparse_tpu/ops/loss.py:238 (_ce_bwd_kernel)", "train_t16368_v50265_d768"),
    ("window_attention", "cuda", "pixparse_tpu_torch/csrc/window_attention.cu",
     "pixparse_tpu/ops/window_attention.py:95 (_fwd_kernel)", "stage0_b8_n100_c128_h4_shifted"),
    ("decode_attention_q8", "cuda", "pixparse_tpu_torch/csrc/decode_attention_q8.cu",
     "pixparse_tpu/ops/decode_attention.py:140 (_decode_attn_q8_kernel)",
     "cross_b16_lk1024_valid1009"),
    ("window_attention_bwd", "cuda", "pixparse_tpu_torch/csrc/window_attention_bwd.cu",
     "pixparse_tpu/ops/window_attention.py:126 (_bwd_kernel)", "stage0_b2_n100_c128_h4_shifted"),
    ("layer_norm_fwd", "cuda", "pixparse_tpu_torch/csrc/layer_norm.cu",
     "pixparse_tpu/ops/layer_norm.py:76 (_fwd_kernel)", "swin_stage0_r614400_d128_bfloat16"),
    ("layer_norm_bwd", "cuda", "pixparse_tpu_torch/csrc/layer_norm.cu",
     "pixparse_tpu/ops/layer_norm.py:86 (_bwd_kernel)", "swin_stage0_r614400_d128_bfloat16"),
    # the probe tools' kernels; the line's case for #16 is k64 (the others: kernel_cases.json)
    ("mxu_dots", "cuda", "pixparse_tpu_torch/csrc/mxu_probe.cu",
     "tools/mxu_probe.py:30 (kern_k64), :39 (kern_k128), :48 (kern_k64x2)",
     "k64_m512_n256_r64_g256"),
    ("banded_attention", "cuda", "pixparse_tpu_torch/csrc/window_band.cu",
     "tools/window_band_probe.py:39 (band_fwd_kernel)", "stage0_b4_320x240_c128_h4"),
]
# the kernels each main path must launch
SERVE_KERNELS = ("flash_attention_fwd", "decode_attention")
EVAL_KERNELS = {  # eval_task's two runs
    "donut_base": ("window_attention", "decode_attention"),
    "cruller_base_int8": ("flash_attention_fwd", "decode_attention", "decode_attention_q8"),
}
PROBE_OWN_KERNELS = ("mxu_dots", "banded_attention")  # #16, #17: only the probes run them
PROBE_KERNELS = PROBE_OWN_KERNELS + ("window_attention",)  # probes' run
TRAIN_KERNELS = {  # train_task's runs
    "cruller_base": ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd"),
    "donut_base": ("window_attention", "window_attention_bwd", "flash_attention_fwd",
                   "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd"),
}


def counters():
    from pixparse_tpu_torch.ops.decode_attention import decode_attention, decode_attention_q8
    from pixparse_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from pixparse_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from pixparse_tpu_torch.ops.loss import fused_ce_bwd, fused_ce_fwd
    from pixparse_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from pixparse_tpu_torch.tools.mxu_probe import mxu_dots
    from pixparse_tpu_torch.tools.window_band_probe import banded_attention

    return {"flash_attention_fwd": flash_attention_fwd, "decode_attention": decode_attention,
            "flash_attention_bwd": flash_attention_bwd, "fused_ce_fwd": fused_ce_fwd,
            "fused_ce_bwd": fused_ce_bwd, "window_attention": window_attention,
            "decode_attention_q8": decode_attention_q8,
            "window_attention_bwd": window_attention_bwd, "layer_norm_fwd": layer_norm_fwd,
            "layer_norm_bwd": layer_norm_bwd, "mxu_dots": mxu_dots,
            "banded_attention": banded_attention}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


# --------------------------------------------------------------------------
# probes
# --------------------------------------------------------------------------

# Both variants round q/k/v, p and o to bf16 at the same points, so they
# should agree to a bf16 ulp of o (|o| ~ 0.05 here: 2.4e-4); a dropped bias
# moves o by ~2e-3.
BAND_PARITY_ATOL = 1e-3


def phase_probes(torch):
    """The probe tools' main paths, ``python -m pixparse_tpu_torch.tools.
    mxu_probe`` and ``... .window_band_probe all``, on the card (their
    printout to stderr). Counters zeroed just before, read just after; each
    probe kernel must have launched; the answers must be finite and the two
    window variants agree."""
    import contextlib
    import math

    from pixparse_tpu_torch.tools import mxu_probe, window_band_probe

    reset_counts()
    with contextlib.redirect_stdout(sys.stderr):
        mxu = mxu_probe.main([])
        band = window_band_probe.main(["all"])
    sync(torch)
    counts = read_counts()
    emit({"phase": "probes", "mxu": mxu, "window_band": band, "launches": counts})
    # the two answers, on lines of their own
    matmul_us = next(r["us"] for r in mxu if r["variant"] == "matmul")
    emit({"probe_answer": "mxu", "useful_tflops": {r["variant"]: r["tflops"] for r in mxu},
          "time_over_matmul": {r["variant"]: r["us"] / matmul_us for r in mxu
                               if r["variant"] != "matmul"}})
    emit({"probe_answer": "window_band",
          "banded_over_current": {r["name"]: r["banded_ms"] / r["current_ms"] for r in band},
          "band_kernel_over_window_kernel": {
              r["name"]: r["band_kernel_ms"] / r["window_kernel_ms"] for r in band}})
    missing = [k for k in PROBE_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"probes: kernels never launched: {missing}")
    bad = [r["variant"] for r in mxu if not (math.isfinite(r["tflops"]) and r["tflops"] > 0)]
    bad += [r["name"] for r in band
            if not (r["max_abs_diff"] <= BAND_PARITY_ATOL
                    and all(math.isfinite(v) and v > 0 for k, v in r.items() if k.endswith("_ms")))]
    if bad:
        raise SystemExit(f"probes: bad answers for {bad}")
    return counts


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
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"serve_task: main path never launched {missing}")
    return launches


def phase_serve_donut(torch, new_tokens=DONUT_NEW_TOKENS, B=8, model_name="donut_base",
                      device="cuda", profile=False):
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
    from pixparse_tpu_torch.ops.generation import generate

    enc_cfg, bart_cfg, _ = resolve_cruller_cfgs(get_model_config(model_name))
    gen = torch.Generator().manual_seed(0)
    model = Cruller(enc_cfg, bart_cfg, attn_impl="flash").init_weights(gen)
    model = model.to(device, torch.bfloat16).eval()
    images = synthetic_pages(torch, B, *enc_cfg.img_size, gen)
    images = images.expand(-1, -1, -1, enc_cfg.in_chans).contiguous().to(device)
    on_card = torch.cuda.is_available()

    with torch.inference_mode():
        enc = model.encode(images)  # warm-up (shift masks, cuBLAS handles)
        sync(torch)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        enc = model.encode(images)
        sync(torch)
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = read_counts()
        enc1 = model.encode(images[:1])
        model.attn_impl = "xla"
        enc1_plain = model.encode(images[:1])
        model.attn_impl = "flash"
        enc_err, _ = close(enc1, enc1_plain, 5e-2, 5e-2)
        enc_ref_max = float(enc1_plain.float().abs().max())
        _, enc_row_err, enc_ok = rows_close(enc1[0], enc1_plain[0], 5e-2)
        del enc1, enc1_plain

        prompt = torch.zeros(B, 1, dtype=torch.long, device=device)  # <s>
        kwargs = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1)
        generate(model, enc, prompt, **dict(kwargs, max_length=9))  # warm-up
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        res = generate(model, enc, prompt, **kwargs)
        sync(torch)
        gen_s = time.perf_counter() - t0
        dec_launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
        dec_err, dec_ok = cached_vs_parallel(torch, model, enc, res.tokens[:, :16])
        if profile:
            prof = {
                "encode": device_profile(
                    torch, lambda: model.encode(images), "donut_encode", encode_ms),
                "generate": device_profile(
                    torch, lambda: generate(model, enc, prompt, **kwargs), "donut_generate",
                    gen_s * 1e3),
            }
    steps = res.steps
    rec = {
        "phase": "serve_donut", "model": model_name, "batch": B, "dtype": "bfloat16",
        "image_size": list(enc_cfg.img_size), "vocab": bart_cfg.vocab_size,
        "encoder_tokens": enc_cfg.num_tokens, "new_tokens": new_tokens, "decode_steps": steps,
        "encode_launches": enc_launches, "generate_launches": dec_launches,
        "encode_kernel_vs_plain_b1_max_abs_err": enc_err, "encode_ref_abs_max": enc_ref_max,
        "encode_kernel_vs_plain_b1_worst_token_rel_err": enc_row_err,
        "encode_tol": ["token L2", 5e-2],
        "decode_cached_vs_parallel_max_abs_err": dec_err, "decode_tol": [5e-2, 5e-2],
        "encode_ms": encode_ms, "generate_ms": gen_s * 1e3,
        "decode_ms_per_step": gen_s * 1e3 / max(steps, 1),
        "pages_per_s": B / (encode_ms / 1e3 + gen_s), "tokens_per_s": B * new_tokens / gen_s,
        "peak_memory_gib": peak_gb, "tokens_shape": list(res.tokens.shape),
    }
    if profile:
        rec["profile"] = prof
    emit(rec)
    problems = []
    if enc_launches["window_attention"] != enc_cfg.depth or enc_launches["flash_attention_fwd"]:
        problems.append(f"encode launched {enc_launches}, want {enc_cfg.depth} window attention")
    want = 2 * bart_cfg.decoder_layers * steps
    if dec_launches["decode_attention"] != want or steps != new_tokens - 1:
        problems.append(f"generate ran {dec_launches['decode_attention']} decode launches over {steps} steps, want {want}")
    if dec_launches["window_attention"] or dec_launches["decode_attention_q8"]:
        problems.append(f"generate launched {dec_launches}")
    if not enc_ok:
        problems.append(f"window-kernel encoder differs from the plain encoder by {enc_err}")
    if not dec_ok:
        problems.append(f"cached decode logits differ from the parallel pass by {dec_err}")
    if tuple(res.tokens.shape) != (B, 1 + new_tokens) or not bool((res.lengths == 1 + new_tokens).all()):
        problems.append(f"tokens {tuple(res.tokens.shape)} lengths {res.lengths.tolist()}")
    if problems:
        raise SystemExit("serve_donut failed: " + "; ".join(problems))
    return rec


def saved_tokenizer(path, vocab):
    """The byte-level tokenizer, the OCR tasks' special tokens (those the
    pretrain phase adds) at the ids their replay gives them, then filler
    tokens up to ``vocab`` entries, saved to ``path`` (the task's tokenizer
    name)."""
    from pixparse_tpu_torch.task.common import SPECIAL_TOKENS_FROM_PRETRAIN, add_special_tokens
    from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer

    tokenizer = ByteLevelTokenizer()
    add_special_tokens(tokenizer, SPECIAL_TOKENS_FROM_PRETRAIN)
    tokenizer.add_tokens([f"<filler_{i}>" for i in range(vocab - len(tokenizer))])
    tokenizer.save_pretrained(path)
    return path


def eval_task_setup(torch, model_name, mode, tok_dir, device):
    """The registered ``cruller_eval_ocr`` task on ``device`` in bf16, set
    up, with every row of its tied table but the byte tokens' zeroed: with
    random weights the prompt token's own row would win every greedy step,
    and the fillers and tags clean to empty text, leaving no CER/WER."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerEvalOCRCfg(
        model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
        device=device, kv_cache_dtype=mode, lm_head_dtype=mode,
    )
    task, _ = TaskFactory.create_task("cruller_eval_ocr", cfg, DeviceEnv.initialize(device))
    task.setup()
    with torch.no_grad():
        table = task.model.tied_embedding
        table[:BYTE_IDS[0]] = 0
        table[BYTE_IDS[1]:] = 0
    return task


def phase_eval_task(torch, runs=None, device="cuda"):
    """``runs``: (tag, model name, decode mode, vocabulary, batch, batches,
    reference length) for each eval run."""
    import shutil
    import tempfile

    import numpy as np

    from pixparse_tpu_torch.framework.eval import evaluate

    runs = runs or (
        ("donut_base", "donut_base", "bf16", 57525, 8, 2, 48),
        ("cruller_base_int8", "cruller_base", "int8", BART_VOCAB, 16, 2, 48),
    )
    rec = {"phase": "eval_task", "task": "cruller_eval_ocr", "dtype": "bfloat16", "runs": {}}
    path_launches = {}
    problems = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_task_")
    try:
        for tag, model_name, mode, vocab, B, n_batches, length in runs:
            tok_dir = saved_tokenizer(os.path.join(tmp, f"tok{vocab}"), vocab)
            task = eval_task_setup(torch, model_name, mode, tok_dir, device)
            if task.vocab_size != vocab:
                raise SystemExit(f"eval_task: {tag} has vocab {task.vocab_size}, want {vocab}")
            enc_cfg = task.vit_cfg
            # reference texts of byte tokens
            batches = lambda n, B, seed: SeededLoader(
                torch, n, B, enc_cfg.img_size, length, seed, enc_cfg.in_chans, BYTE_IDS[1])
            loader = batches(n_batches, B, vocab)
            evaluate(task, {"eval": batches(1, 2, 1)})  # warm-up
            sync(torch)
            reset_counts()
            t0 = time.perf_counter()
            metrics = evaluate(task, {"eval": loader, "train": loader})
            sync(torch)
            dt = time.perf_counter() - t0
            launches = read_counts()
            path_launches[f"eval_task_{tag}"] = launches
            run = {"model_name": model_name, "decode_mode": mode, "vocab": vocab, "batch": B,
                   "batches": n_batches, "seconds": dt, "pages_per_s": B * n_batches / dt,
                   "metrics": metrics, "launches": launches}
            if mode == "int8":
                # int8 vs bf16 greedy tokens on one batch, the same weights
                image, text, _ = loader.batches[0]
                prompt = task.prompt_ids(task.task_start_token, B)
                ids_i8 = task.generate_ids(image, prompt, max_length=64)
                del task
                task = eval_task_setup(torch, model_name, "bf16", tok_dir, device)
                ids_bf = task.generate_ids(image, prompt, max_length=64)
                run["int8_vs_bf16_token_agreement"] = float(
                    np.mean(ids_i8[:, 1:] == ids_bf[:, 1:]))
            rec["runs"][tag] = run
            avg = metrics.get("eval", {}).get("average", {})
            if set(metrics) != {"eval"} or not all(
                    k in avg and np.isfinite(avg[k]) for k in ("cer", "wer")):
                problems.append(f"{tag}: CER/WER missing or not finite: {metrics}")
            missing = [k for k in EVAL_KERNELS[tag] if launches[k] <= 0]
            if missing:
                problems.append(f"{tag}: main path never launched {missing}")
            del task
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(rec)
    if problems:
        raise SystemExit("eval_task failed: " + "; ".join(problems))
    return path_launches


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def synthetic_tokens(torch, B, length, vocab, gen):
    """Unshifted token rows as the OCR annotation pipeline makes them: the
    task token, random text ids, </s>, then padding (masked in the target
    along with the prompt)."""
    text = torch.full((B, length), 1, dtype=torch.long)  # <pad>
    target = torch.full((B, length), -100, dtype=torch.long)
    for b in range(B):
        n = int(torch.randint(length // 2, length - 1, (1,), generator=gen))
        ids = torch.randint(4, vocab, (n,), generator=gen)
        ids[0] = 260  # <s_pretrain>, the first id after the byte-level vocabulary
        ids[-1] = 2  # </s>
        text[b, :n] = ids
        target[b, 1:n] = ids[1:]
    return text, target


def build_train_model(torch, model_name, device, lr=3e-4, vocab=BART_VOCAB):
    """(model, optimizer, vit_cfg, bart_cfg): the registered model at
    ``vocab`` entries, fp32 master weights on the card, bf16 forward, the
    decoder's dropout at its configured 0.1."""
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.optimization import create_optimizer
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs

    vit_cfg, bart_cfg, _ = resolve_cruller_cfgs(get_model_config(model_name), vocab_size=vocab)
    model = Cruller(vit_cfg, bart_cfg, attn_impl="flash", compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=torch.float32).train()
    model.decoder.dropout_generator = torch.Generator(device=device)
    optimizer, _ = create_optimizer(
        OptimizationCfg(learning_rate=lr), num_intervals=1, num_warmup_intervals=0,
        updates_per_interval=1000, encoder_depth=vit_cfg.depth,
        decoder_layers=bart_cfg.decoder_layers,
    )
    return model, optimizer, vit_cfg, bart_cfg


def phase_train_model(torch, steps=TRAIN_STEPS, B=16, model_name="cruller_base", device="cuda",
                      profile=False):
    from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
    from pixparse_tpu_torch.ops import loss as loss_ops

    model, optimizer, vit_cfg, bart_cfg = build_train_model(torch, model_name, device)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    L = bart_cfg.max_position_embeddings
    images = synthetic_pages(torch, B, *vit_cfg.img_size, gen).to(device)
    text, target = synthetic_tokens(torch, B, L, BART_VOCAB, gen)
    batch = {"image": images, "text": text[:, :-1].to(device), "target": target[:, 1:].to(device)}

    def make_step(ce):
        def loss_fn(b):
            hidden = model.forward_hidden(b["image"], b["text"])
            return ce(hidden, model.tied_embedding.to(hidden.dtype), b["target"])[0], {}

        return make_train_step(
            loss_fn, optimizer, reseed=model.decoder.dropout_generator.manual_seed)

    def first_step(ce, attn_impl, n):
        """Loss and gradient norm of step 1 from the initial weights."""
        model.load_state_dict(init)
        model.attn_impl = attn_impl
        state = create_train_state(model, optimizer, seed=0)
        _, m = make_step(ce)(state, {k: v[:n] for k, v in batch.items()})
        return float(m["loss"]), float(m["grad_norm"])

    # kernel path against plain path at a batch of 2 (plain attention keeps
    # (B, 12, L, L) fp32 scores per layer for its backward)
    reset_counts()
    k_loss, k_gn = first_step(loss_ops.cross_entropy_from_hidden, "flash", 2)
    small_launches = read_counts()
    reset_counts()
    p_loss, p_gn = first_step(loss_ops.chunked_cross_entropy_from_hidden, "xla", 2)
    plain_launches = read_counts()
    torch.cuda.empty_cache()

    model.load_state_dict(init)
    model.attn_impl = "flash"
    state = create_train_state(model, optimizer, seed=0)
    step = make_step(loss_ops.cross_entropy_from_hidden)
    losses, grad_norms, times, per_step = [], [], [], []
    on_card = torch.cuda.is_available()  # a CPU rehearsal at test size skips the card's meters
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        reset_counts()
        sync(torch)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_counts())
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    ms_per_step = statistics.median(times[1:])
    from pixparse_tpu_torch.framework.profiling import cruller_train_flops, mfu

    flops = cruller_train_flops(vit_cfg, bart_cfg, B, L - 1)
    rec = {
        "phase": "train_model", "model": model_name, "batch": B, "dtype": "bfloat16",
        "master_dtype": "float32", "vocab": BART_VOCAB, "text_len": L - 1,
        "encoder_tokens": vit_cfg.num_tokens, "steps": steps, "losses": losses,
        "grad_norms": grad_norms, "step_ms": times, "ms_per_step": ms_per_step,
        "samples_per_s": B / (ms_per_step / 1e3), "peak_memory_gib": peak_gb,
        "model_flops_per_step": flops, "mfu": mfu(flops, ms_per_step / 1e3, device=device),
        "launches_per_step": per_step[-1], "launch_unit": "wrapper calls",
        "kernel_vs_plain_b2": {
            "kernel": [k_loss, k_gn], "plain": [p_loss, p_gn], "tol_rel": [2e-2, 5e-2],
            "kernel_launches": small_launches, "plain_launches": plain_launches,
        },
    }
    if profile:
        holder = {"state": state}

        def one_step():
            holder["state"], _ = step(holder["state"], batch)

        rec["profile"] = device_profile(torch, one_step, "train_step", ms_per_step)
    emit(rec)
    problems = []
    layers = vit_cfg.depth + 2 * bart_cfg.decoder_layers
    want = dict({k: 0 for k in counters()}, flash_attention_fwd=layers,
                flash_attention_bwd=layers, fused_ce_fwd=1, fused_ce_bwd=1)
    for i, got in enumerate(per_step):
        if got != want:
            problems.append(f"step {i} launched {got}, want {want}")
            break
    if any(plain_launches.values()):
        problems.append(f"the plain path launched kernels: {plain_launches}")
    if not all(x == x and abs(x) != float("inf") for x in losses + grad_norms):
        problems.append(f"non-finite loss or gradient norm: {losses} {grad_norms}")
    elif not losses[-1] < losses[0]:
        problems.append(f"loss did not fall on the repeated batch: {losses}")
    if abs(k_loss - p_loss) > 2e-2 * abs(p_loss):
        problems.append(f"step-1 loss: kernel path {k_loss} vs plain path {p_loss}")
    if abs(k_gn - p_gn) > 5e-2 * abs(p_gn):
        problems.append(f"step-1 gradient norm: kernel path {k_gn} vs plain path {p_gn}")
    if problems:
        raise SystemExit("train_model failed: " + "; ".join(problems))
    return rec


REMAT_MODES = (False, "gelu", "mlp", "dots", True)  # none, gelu, mlp (auto for donut), dots, full


def phase_train_donut(torch, steps=DONUT_TRAIN_STEPS, B=2, model_name="donut_base",
                      device="cuda", profile=False):
    """donut_base as registered (Swin-B window 10 on 2560x1920 RGB, the
    4-layer pre-LN mBART decoder, d 1024, vocab 57525, dropout 0.1), text
    1535, fp32 master weights, bf16 forward, AdamW, one fixed seeded batch:
    ``steps`` train steps under each remat mode from the same weights and
    dropout seed; the kernel path against the plain path at B=1; the
    LayerNorm kernels opt-in (PIXPARSE_LN_IMPL=pallas) under 'mlp'."""
    from pixparse_tpu_torch.framework.profiling import cruller_train_flops, mfu
    from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
    from pixparse_tpu_torch.ops import loss as loss_ops
    from pixparse_tpu_torch.ops.layer_norm import LayerNorm

    model, optimizer, enc_cfg, bart_cfg = build_train_model(
        torch, model_name, device, vocab=DONUT_VOCAB)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    L = bart_cfg.max_position_embeddings
    images = synthetic_pages(torch, B, *enc_cfg.img_size, gen).expand(-1, -1, -1, enc_cfg.in_chans)
    images = images.contiguous().to(device)
    text, target = synthetic_tokens(torch, B, L, DONUT_VOCAB, gen)
    batch = {"image": images, "text": text[:, :-1].to(device), "target": target[:, 1:].to(device)}
    on_card = torch.cuda.is_available()
    flops = cruller_train_flops(enc_cfg, bart_cfg, B, L - 1)
    n_ln = sum(isinstance(m, LayerNorm) for m in model.modules())

    def make_step(ce=loss_ops.cross_entropy_from_hidden):
        def loss_fn(b):
            hidden = model.forward_hidden(b["image"], b["text"])
            return ce(hidden, model.tied_embedding.to(hidden.dtype), b["target"])[0], {}

        return make_train_step(loss_fn, optimizer, reseed=model.decoder.dropout_generator.manual_seed)

    def run(remat, n_steps, data=batch, attn_impl="flash", ce=loss_ops.cross_entropy_from_hidden):
        """Steps from the initial weights: per-step losses, gradient norms,
        times and launch counts, and the peak memory."""
        model.load_state_dict(init)
        model.attn_impl = attn_impl
        model.remat = remat
        state = create_train_state(model, optimizer, seed=0)
        step = make_step(ce)
        out = {"losses": [], "grad_norms": [], "step_ms": [], "launches": []}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(n_steps):
            reset_counts()
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, data)
            sync(torch)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(read_counts())
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
        ms = statistics.median(out["step_ms"][1:] or out["step_ms"])
        out.update(ms_per_step=ms, samples_per_s=B / (ms / 1e3),
                   mfu=mfu(flops, ms / 1e3, device=device))
        if profile and remat == "mlp":
            holder = {"state": state}

            def one_step():
                holder["state"], _ = step(holder["state"], data)

            ln = "_ln_opt_in" if os.environ.get("PIXPARSE_LN_IMPL") == "pallas" else ""
            out["profile"] = device_profile(torch, one_step, f"donut_train_step_{tag(remat)}{ln}", ms)
        return out

    tag = lambda mode: {False: "none", True: "full"}.get(mode, mode)
    modes = {}
    for remat in REMAT_MODES:
        modes[tag(remat)] = run(remat, steps)
        torch.cuda.empty_cache()
    # the LayerNorm kernels opt-in, under the auto mode
    os.environ["PIXPARSE_LN_IMPL"] = "pallas"
    try:
        ln_run = run("mlp", steps)
    finally:
        del os.environ["PIXPARSE_LN_IMPL"]
    torch.cuda.empty_cache()
    # kernel path against plain path at B=1 (plain window and decoder attention, plain CE)
    one = {k: v[:1] for k, v in batch.items()}
    k1 = run(False, 1, one)
    p1 = run(False, 1, one, attn_impl="xla", ce=loss_ops.chunked_cross_entropy_from_hidden)
    model.attn_impl = "flash"
    rec = {
        "phase": "train_donut", "model": model_name, "batch": B, "dtype": "bfloat16",
        "master_dtype": "float32", "vocab": DONUT_VOCAB, "text_len": L - 1,
        "image_size": list(enc_cfg.img_size), "encoder_tokens": enc_cfg.num_tokens,
        "model_flops_per_step": flops, "launch_unit": "wrapper calls", "modes": modes,
        "ln_opt_in_mlp": ln_run, "layer_norms": n_ln,
        "kernel_vs_plain_b1": {"kernel": [k1["losses"][0], k1["grad_norms"][0]],
                               "plain": [p1["losses"][0], p1["grad_norms"][0]],
                               "tol_rel": [2e-2, 5e-2], "plain_launches": p1["launches"][0]},
    }
    emit(rec)
    problems = []
    ref = modes["none"]
    blocks, dec_sites = enc_cfg.depth, 2 * bart_cfg.decoder_layers
    for name, r in modes.items():
        recompute = name in ("full", "dots")
        want = dict({k: 0 for k in counters()},
                    window_attention=blocks * (2 if recompute else 1), window_attention_bwd=blocks,
                    flash_attention_fwd=dec_sites * (2 if recompute else 1),
                    flash_attention_bwd=dec_sites, fused_ce_fwd=1, fused_ce_bwd=1)
        bad = [i for i, got in enumerate(r["launches"]) if got != want]
        if bad:
            problems.append(f"{name}: step {bad[0]} launched {r['launches'][bad[0]]}, want {want}")
        if not all(x == x and abs(x) != float("inf") for x in r["losses"] + r["grad_norms"]):
            problems.append(f"{name}: non-finite loss or gradient norm")
        if abs(r["losses"][0] - ref["losses"][0]) > 1e-6 * abs(ref["losses"][0]):
            problems.append(f"{name}: step-1 loss {r['losses'][0]} vs {ref['losses'][0]} (none)")
        if abs(r["grad_norms"][0] - ref["grad_norms"][0]) > 1e-3 * abs(ref["grad_norms"][0]):
            problems.append(
                f"{name}: step-1 gradient norm {r['grad_norms'][0]} vs {ref['grad_norms'][0]} (none)")
    want_ln = dict(modes["mlp"]["launches"][0], layer_norm_fwd=n_ln, layer_norm_bwd=n_ln)
    bad = [i for i, got in enumerate(ln_run["launches"]) if got != want_ln]
    if bad:
        problems.append(f"LayerNorm opt-in step {bad[0]} launched {ln_run['launches'][bad[0]]}, "
                        f"want {want_ln}")
    auto = modes["mlp"]
    if abs(ln_run["losses"][0] - auto["losses"][0]) > 2e-2 * abs(auto["losses"][0]):
        problems.append(f"LayerNorm opt-in loss {ln_run['losses'][0]} vs {auto['losses'][0]}")
    if abs(ln_run["grad_norms"][0] - auto["grad_norms"][0]) > 5e-2 * abs(auto["grad_norms"][0]):
        problems.append(
            f"LayerNorm opt-in gradient norm {ln_run['grad_norms'][0]} vs {auto['grad_norms'][0]}")
    if any(p1["launches"][0].values()):
        problems.append(f"the plain path launched kernels: {p1['launches'][0]}")
    (kl, kg), (pl, pg) = rec["kernel_vs_plain_b1"]["kernel"], rec["kernel_vs_plain_b1"]["plain"]
    if abs(kl - pl) > 2e-2 * abs(pl) or abs(kg - pg) > 5e-2 * abs(pg):
        problems.append(f"B=1 step 1: kernel path {kl, kg} vs plain path {pl, pg}")
    if problems:
        raise SystemExit("train_donut failed: " + "; ".join(problems))
    return {"train_donut_ln_opt_in": ln_run["launches"][-1]}


class SeededLoader:
    """In-memory stand-in for the webdataset loader bundle: ``num_batches``
    collated batches ``(image, text, target)`` made from a seed, the same
    ones every interval (``loader`` / ``num_batches`` / ``set_interval`` is
    the surface the interval loop, ``evaluate`` and the tasks use). Token
    ids are drawn below ``vocab``."""

    def __init__(self, torch, num_batches, B, img_size, length, seed, in_chans=1,
                 vocab=BART_VOCAB):
        gen = torch.Generator().manual_seed(seed)
        self.batches = []
        for _ in range(num_batches):
            image = synthetic_pages(torch, B, *img_size, gen).expand(-1, -1, -1, in_chans)
            text, target = synthetic_tokens(torch, B, length, vocab, gen)
            self.batches.append((image.contiguous().numpy(), text.numpy(), target.numpy()))
        self.num_batches = num_batches
        self.num_samples = num_batches * B
        self.loader = self
        self.interval = 0

    def set_interval(self, interval):
        self.interval = interval

    def __iter__(self):
        return iter(self.batches)


TRAIN_TASK_RUNS = (  # model, vocabulary, gradient accumulation, batch, batches per interval
    ("cruller_base", BART_VOCAB, 1, 16, 3),
    ("cruller_base", BART_VOCAB, 2, 8, 4),
    ("donut_base", DONUT_VOCAB, 1, 2, 2),
)


def phase_train_task(torch, runs=TRAIN_TASK_RUNS, device="cuda"):
    """``cruller_pretrain`` through ``train_one_interval`` for each run (two
    intervals over the same seeded batches, auto remat); returns the launch
    counts of each model's runs, read after its runs with the counters zeroed
    before."""
    import shutil
    import tempfile

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.checkpoint import restore_train_state, save_checkpoint
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.train import train_one_interval
    from pixparse_tpu_torch.task.task_cruller_pretrain import (
        TaskCrullerPretrain,
        TaskCrullerPretrainCfg,
    )
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    env = DeviceEnv.initialize(device)
    recs = {}
    totals = {}
    ckpt = None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_task_")
    try:
        for model_name, vocab, accum, B, n_batches in runs:
            # a tokenizer of the model's published height (the tied table's
            # height is what the fused-CE kernels stream)
            tok_dir = os.path.join(tmp, f"tokenizer{vocab}")
            if not os.path.isdir(tok_dir):
                saved_tokenizer(tok_dir, vocab)
            cfg = TaskCrullerPretrainCfg(
                model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir),
                dtype="bfloat16", device=device, num_intervals=2, num_warmup_intervals=0,
                opt=OptimizationCfg(learning_rate=3e-4, grad_accum_steps=accum),
            )
            task, _ = TaskFactory.create_task("cruller_pretrain", cfg, env, monitor=None)
            if type(task) is not TaskCrullerPretrain or task.vocab_size != vocab:
                raise SystemExit(f"train_task: got {type(task).__name__}, vocab {task.vocab_size}")
            enc_cfg = task.vit_cfg
            loader = SeededLoader(torch, n_batches, B, enc_cfg.img_size,
                                  task.max_position_embeddings, seed=accum, in_chans=enc_cfg.in_chans,
                                  vocab=vocab)
            task.train_setup(num_batches_per_interval=loader.num_batches, seed=0)
            reset_counts()
            losses = []
            t0 = time.perf_counter()
            for interval in range(2):  # the same batches again: the loss must fall
                loader.set_interval(interval)
                task.interval_idx = interval
                train_one_interval(task, loader)
                losses.append(float(task._last_loss_dev))
            sync(torch)
            dt = time.perf_counter() - t0
            launches = read_counts()
            total = totals.setdefault(model_name, {k: 0 for k in counters()})
            for k, n in launches.items():
                total[k] += n
            updates = 2 * n_batches // accum
            recs.setdefault(model_name, {})[f"accum{accum}"] = {
                "vocab": vocab, "batch": B, "batches_per_interval": n_batches, "updates": updates,
                "remat": task.model.remat, "state_step": task.state.step,
                "task_step_idx": task.step_idx, "interval_end_losses": losses, "seconds": dt,
                "samples_per_s": 2 * n_batches * B / dt, "launches": launches,
            }
            if model_name == "cruller_base" and accum == 1:
                # one full-state checkpoint saved, the live state spoiled, restored
                path = os.path.join(tmp, "checkpoint-1")
                save_checkpoint(path, task.state, metadata={"interval": 1, "step": task.state.step})
                size = os.path.getsize(os.path.join(path, "state.pt"))
                name = "image_encoder.trunk.blocks.0.attn.qkv.weight"
                kept = task.state.params[name].detach().clone()
                mu_kept = task.state.opt_state["mu"][name].clone()
                with torch.no_grad():
                    task.state.params[name].zero_()
                    task.state.opt_state["mu"][name].zero_()
                state, meta = restore_train_state(path, task.state)
                ckpt = {
                    "bytes": size, "metadata": meta, "step": state.step,
                    "restored_exactly": bool(
                        torch.equal(state.params[name], kept)
                        and torch.equal(state.opt_state["mu"][name], mu_kept)
                        and state.params[name] is task.state.params[name]
                    ),
                }
                shutil.rmtree(path, ignore_errors=True)
            del task
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "train_task", "task": "cruller_pretrain",
           "tokenizer": "pixparse_bytelevel + filler tokens, from a saved directory",
           "dtype": "bfloat16", "runs": recs, "checkpoint": ckpt, "launches": totals,
           "launch_unit": "wrapper calls"}
    emit(rec)
    problems = []
    for model_name, model_runs in recs.items():
        for name, run in model_runs.items():
            if run["state_step"] != run["updates"]:
                problems.append(f"{model_name}/{name}: {run['state_step']} updates, want {run['updates']}")
            a, b = run["interval_end_losses"]
            if not (a == a and b == b and b < a):
                problems.append(f"{model_name}/{name}: loss not finite and falling: {a} -> {b}")
        missing = [k for k in TRAIN_KERNELS.get(model_name, ()) if totals[model_name][k] <= 0]
        if missing:
            problems.append(f"{model_name}: main path never launched {missing}")
    if "cruller_base" in recs and (
            not ckpt or not ckpt["restored_exactly"] or ckpt["metadata"].get("interval") != 1):
        problems.append(f"checkpoint round trip failed: {ckpt}")
    if problems:
        raise SystemExit("train_task failed: " + "; ".join(problems))
    return {f"train_task_{m}": t for m, t in totals.items()}


# the wgmma kernels, by (mangled) name fragment; their dynamic shared memory
# per template argument, as FwdCfg / BwdCfg (flash, by head dim) and GemmCfg
# (the CE backward's products, by output tile width BN) lay it out
WGMMA_FLASH = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")
WGMMA_CE = ("ce_gemm_kernel",)
CE_PRODUCTS = ("K1_g", "K2_dE", "K3_dh", "F_lse")  # by the template's product index
CE_FWD = ("ce_gemm_kernel", "ce_lse_merge_kernel")  # ce_fwd_ptxas: product F and the merge
DECODE = ("decode_attn_split_kernel",)
WINDOW = ("window_fwd_ring_kernel", "window_bwd_ring_kernel")  # at ww 100, head dim 32


def flash_dynamic_smem(kernel, D):
    stages = 2 if D == 128 else 3
    if kernel == "flash_fwd_wgmma_kernel":  # two Q buffers, then stages of K and V, 128 rows each
        return 2 * 128 * D * 2 + stages * 2 * 128 * D * 2 + (2 * stages + 4) * 8 + 1024
    # two own 128-row tiles, stages of two 64-row tiles + 1024 bytes of stats
    return 2 * 128 * D * 2 + stages * (2 * 64 * D * 2 + 1024) + (2 * stages + 1) * 8 + 1024


def ce_dynamic_smem(BN):
    # 4 stages of a 128 x 64 A tile and a BN x 64 B tile, 8 barriers, alignment
    return 4 * (128 * 64 * 2 + BN * 64 * 2) + 2 * 4 * 8 + 1024


def decode_dynamic_smem(kt, HD, H, split_keys, elt):
    """The decode kernel's dynamic shared memory for a plan, as its Smem
    lays it out: barriers, 3 stages of K and V tiles (or the p.v sums),
    scores and probabilities, (max, max, alpha) per head, the split's mask."""
    ring = max(3 * 2 * kt * HD * elt, 256 * (16 // elt + 1) * 4)
    return -(-(128 + ring + 8 * kt * H + 12 * H + split_keys) // 16) * 16


def ptxas_summary(log, kernels=WGMMA_FLASH, ce_products=CE_PRODUCTS[:3]):
    """Registers, spills and shared memory of the wgmma flash kernels (or,
    with ``kernels=WGMMA_CE``, the CE products named in ``ce_products``; with
    ``DECODE``, the decode kernels, whose dynamic shared memory follows the
    plan and is in each decode case's record; with ``WINDOW``, the window
    kernels at donut_base's ww 100 and head dim 32), from what ``nvcc
    -Xptxas -v`` printed when the library was built."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            cur = None
            if name in WGMMA_CE:
                prod, bn = (int(x) for x in re.search(r"ILi(\d+)ELi(\d+)E", m.group(1)).groups())
                if CE_PRODUCTS[prod] in ce_products:
                    cur = {"kernel": name, "product": CE_PRODUCTS[prod], "BN": bn,
                           "dynamic_smem_bytes": ce_dynamic_smem(bn)}
                    out.append(cur)
            elif name in DECODE:
                d = re.search(r"Li(\d+)E", m.group(1))
                cur = {"kernel": name, "dtype": "bf16" if "bfloat16" in m.group(1) else "fp32",
                       "D": int(d.group(1)) if d else None}
                out.append(cur)
            elif name in WINDOW:
                d, rt = (int(x) for x in re.search(r"ILi(\d+)ELi(\d+)E", m.group(1)).groups())
                if (d, rt) == (32, 7):  # donut_base's windows
                    cur = {"kernel": name, "D": d, "row_tiles": rt,
                           "bias_mask_in_smem": "Lb0E" not in m.group(1)}
                    out.append(cur)
            elif name == "ce_lse_merge_kernel":
                cur = {"kernel": name, "dynamic_smem_bytes": 0}
                out.append(cur)
            elif name:
                d = re.search(r"ILi(\d+)E", m.group(1))
                D = int(d.group(1)) if d else None
                cur = {"kernel": name, "D": D, "dynamic_smem_bytes": flash_dynamic_smem(name, D)
                       if D else None}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="serve_model, serve_donut, train_model, train_donut: also trace encode, "
                         "generate and one train step with torch.profiler (device time by "
                         "kernel, device idle share)")
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
    open(os.path.join(OUT_DIR, "phases.jsonl"), "w").close()  # this run's lines only

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
        for stem in _build.SIGNATURES:
            fh.write(f"== {stem}\n{_build.ptxas_log(stem)}\n")
    flash_ptxas = (ptxas_summary(_build.ptxas_log("flash_attention"))
                   + ptxas_summary(_build.ptxas_log("flash_attention_bwd")))
    from pixparse_tpu_torch.ops import window_attention as wa

    window_ptxas = []
    for stem, direction in (("window_attention", "fwd"), ("window_attention_bwd", "bwd")):
        ring = wa.window_config(direction, torch.bfloat16, 100, 32, True, 0)  # shifted stage 0
        for rec in ptxas_summary(_build.ptxas_log(stem), WINDOW):
            if rec["bias_mask_in_smem"]:
                rec.update(dynamic_smem_bytes=ring["smem_bytes"], ring=ring)
            window_ptxas.append(rec)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "flash_ptxas": flash_ptxas,
          "ce_ptxas": ptxas_summary(_build.ptxas_log("fused_ce"), WGMMA_CE),
          "ce_fwd_ptxas": ptxas_summary(_build.ptxas_log("fused_ce"), CE_FWD, ("F_lse",)),
          "decode_ptxas": ptxas_summary(_build.ptxas_log("decode_attention"), DECODE),
          "window_ptxas": window_ptxas})

    timer = Timer(torch)
    results = {}
    if "kernels" in phases:
        results = phase_kernels(torch, F, smi, timer)
    path_launches = {}
    if "probes" in phases:
        path_launches["probes"] = phase_probes(torch)
    if "serve_model" in phases:
        phase_serve_model(torch, profile=args.profile)
    if "serve_task" in phases:
        path_launches["serve_task"] = phase_serve_task(torch)
    if "serve_donut" in phases:
        phase_serve_donut(torch, profile=args.profile)
    if "eval_task" in phases:
        path_launches.update(phase_eval_task(torch))
    if "train_model" in phases:
        phase_train_model(torch, profile=args.profile)
    if "train_donut" in phases:
        path_launches.update(phase_train_donut(torch, profile=args.profile))
    if "train_task" in phases:
        path_launches.update(phase_train_task(torch))

    with open(os.path.join(OUT_DIR, "kernel_cases.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    if results:
        line = []
        for name, route, source, replaces, main_case in KERNELS:
            rec = next(r for r in results[name] if r["case"] == main_case)
            line.append({
                "name": name, "route": route, "source": source, "replaces": replaces,
                # summed over the main paths that ran, each read on its own;
                # the probes' run counts only for the probes' own kernels
                "launches": sum(run[name] for p, run in path_launches.items()
                                if p != "probes" or name in PROBE_OWN_KERNELS)
                if path_launches else None,
                "launches_by_path": {p: run[name] for p, run in path_launches.items()},
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                # the probe kernels: busy-timer time and shares
                **({k: rec[k] for k in ("device_ms", "bound_share", "ratio_to_library")}
                   if name in PROBE_OWN_KERNELS else {}),
            })
        emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
