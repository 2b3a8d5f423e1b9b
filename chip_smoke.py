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
   and fully masked decode rows, band masks of live keys after dead ones,
   fp32), and timed with CUDA events (median
   of 25 launches, L2 flushed before each) beside its plain version, one
   ``torch.nn.functional.scaled_dot_product_attention`` call on the same
   inputs (a yardstick only; the port never calls it) and its bound.
   Window attention is held at donut_base's four stage shapes at B=8
   (2560x1920), with and without the shift mask, at the train step's B=2
   (shifted), plus windows 7 and 4 and an fp32 case (its yardstick: SDPA
   with ``attn_mask = bias + mask``), each record with its launch (blocks
   per SM, shared memory, ring stages, mask slots, the plan's runs); the
   int8 decode kernel at the cruller_base and donut_base cross caches (the
   first by a block per (sample, head), the second by key splits), a
   ragged cache with a dead row, a ragged length (997: its scales take plain
   loads) and a cache whose splits end inside runs of masked keys (its
   yardsticks: SDPA and the bf16 decode kernel on the dequantized caches,
   both by the plain and the busy timer; the kernel's integer sums are
   exact, so it is held to its plain version, merging over the same splits,
   within 1e-2/1e-2 in bf16, and to its own bits on a second launch); the
   LayerNorm kernels at every shape of the donut_base B=2 train step, each
   with its launches per step (counted from the model's geometry, 58 in
   all), the same bits on a second launch, and ``device_ms``; each forward
   record carries its launch (``plan``: blocks, blocks per SM, row groups,
   rows a group, rows a thread, lanes a row).
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
   kernel (``decode_ptxas``), of the int8 decode kernel (``q8_ptxas``), of
   the LayerNorm backward and forward (``ln_bwd_ptxas``, ``ln_fwd_ptxas``)
   and of the bf16 window kernels at ww 100 and head dim 32
   (``window_ptxas``), from the build's ``-Xptxas -v`` log.
   Every decode, CE forward and window (forward and backward, dbias
   included) case must give the same bits on a second launch.
   A decode, int8 decode, LayerNorm or window record also carries ``device_ms`` and
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
   accumulator bytes and its peak memory over its inputs. The finetune
   path's shapes join too: flash forward and backward at B=8, causal 511
   and cross 511x1009, and the CE at T 4088 over the CORD vocabulary
   (50322) with the finetune collates' -100 pattern (a prompt prefix and a
   pad tail in every 511-token row). A
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
   (the tar path is the ``loader`` phase's), at cruller_base with the
   byte-level tokenizer padded with filler tokens to bart-base's 50265
   entries (saved to a directory, whose path is the task's tokenizer name:
   the repository holds no bart tokenizer files), with gradient accumulation
   1 and 2; one full-state checkpoint is saved and
   restored. This is the training main-path run: counters zeroed before, read
   after, and each training kernel must have launched.
10. ``pretrained_train``: ``cruller_pretrain`` with both backbones from
   seeded stand-in files of the published ViT-B/16 and bart-base
   (``$PIXPARSE_PRETRAINED_DIR``): the loaded weights equal the file tensors
   adapted independently; 2 steps at B=16.
11. ``finetune_tasks``: the finetune and eval tasks at cruller_base over
   in-process indexable datasets of seeded uint8 pages (CORD-shaped nested
   ``gt_parse`` strings, DocVQA questions of different lengths, RVL-CDIP
   labels) fed through ``HfDatasetLoader`` and each task's ``collate_fn``
   (no PIL, no ``datasets`` on the card machine), the tokenizer padded to
   50265 entries and grown by each task's replay: (a)
   ``cruller_finetune_cord`` from a seeded pretrain checkpoint (50267 ->
   50322 rows), B=8, text 511, two intervals of 2 batches: losses finite,
   the second interval's mean below the first's; on the first batch the
   task's own ``loss_fn`` and every parameter's gradient on the kernel path
   against the plain path (loss 1e-3 relative, each gradient 5e-2 in L2);
   (b)
   ``cruller_eval_{cord,docvqa,rvlcdip}`` in bf16 from (a)'s weights
   (B=8, 8, 16; up to 512, 512, 6 tokens) through ``evaluate``: finite
   metrics, and the first DocVQA decode step on its ragged, left-aligned
   prompts within 5e-2 of a plain parallel pass; (c)
   ``cruller_finetune_xent`` with (a)'s encoder, B=16, 3 steps. Counters
   zeroed before and read after each run, each count equal to what the
   geometry gives: per step (a) depth + 2 x decoder layers flash forward
   and backward and one of each CE kernel, (c) depth flash forward and
   backward; per eval batch depth flash forward and, per single-token
   decode step, 2 x decoder layers decode launches; every other count 0.
   Samples/s, ms/step (median after the first step) and pages/s in the
   phase's line.
12. ``beam_eval``: beam search (K=4) through ``TaskCrullerEvalOCR
   .generate_ids`` with ``num_beams = 4``, seed-0 weights in bf16, EOS
   off, at cruller_base (B=16, 128 tokens; bf16 and the int8 mode) and
   donut_base (B=8, 64 tokens), each beside greedy at the same batch
   (pages/s, decode ms a step, peak memory): ``num_beams=1`` tokens equal
   greedy ``generate``'s; at ``length_penalty=0`` the best beam's summed
   log-prob (one teacher-forced pass) at least the greedy sequence's less
   1e-2; the second decode step, on caches reordered across beams,
   through the decode kernels against the plain decode attention on a
   copy of the same caches within 5e-2/5e-2; exact launch counts (the
   encode's, and 2 x decoder layers decode launches a step, split between
   #8 and #9 in the int8 mode). The reorder alone (``KVCache.reorder``
   at the mean prefix) is timed on the card's clock.
13. ``sample``: ``generate(sample=True)`` at cruller_base, B=16, 64 tokens:
   the same generator seed gives the same tokens, another seed others;
   one step's draws for 4096 repeats of one row pass a chi-square test
   (64 bins of equal expected count) against ``softmax(logits / 5.0)``
   computed in fp64 on the host, p > 1e-3.
14. ``naive``: KV-cached ``generate`` against ``generate_naive`` (a
   cache-free full-prefix pass per token through the flash kernels) at
   cruller_base, B=4, 32 tokens: equal up to the first disagreement, where
   the naive path's top-2 logit margin must be under 0.0625.
15. ``large``: cruller_large (ViT-L/14 on 798x616, 2509 tokens, 24 layers;
   a 10-layer bart-large decoder, vocab 50265) at full width and depth:
   ``serve_model``'s run at B=8, 64 tokens (its encoder held token by
   token: each token's L2 error within 5e-2 of its norm; with the
   profile's idle share) and ``train_model``'s at B=8, 3 steps under the
   auto remat mode (``mlp``), with the B=2 kernel-vs-plain step and the
   exact launch counts (the ``large_serve`` and ``large_train`` lines).
   Both bf16 encoders (kernel path, plain path) are also measured against
   an fp32 plain forward of the same weights (``encode_vs_fp32``: per-token
   L2 error over norm, worst and mean; recorded, not gated).
   The kernels phase holds the flash kernels at its shapes (B=8, H=16:
   2509, causal 1023, 1023x2509) and the CE at T 8184, D 1024, V 50265; the
   decode kernels at 64 rows for ``beam_eval``: the kernels line carries
   them as ``new_path_cases``.
16. ``pix2struct``: pix2struct_base at full width (2048 patches of 16x16
   grayscale, 12 layers, width 768; the 4-layer bart-base decoder, text
   1023, vocab 50265), bf16, seeded weights: 8 pages of four sizes
   (600x800, 3508x2480, 4000x300, 1700x1300) patchified on the card by
   ``ops/pix2struct.py::patchify_variable_batch``, so each page holds
   another number of real patches (2028 / 2014 / 1980 / 1989). Train:
   ``pix2struct_pretrain`` from ``TaskFactory`` (auto remat: none under
   flash), 4 steps of ``train_step`` on the batch (losses finite and
   falling; MFU from ``cruller_train_flops``; exactly 20 flash forward and
   20 backward a step, 12 encoder sites and 4 cross sites with kv_lens, 4
   causal; one CE forward and backward); the task's step-1 loss (2e-2) and
   gradient norm (5e-2) on 2 pages, kernel path against plain path, and
   each gradient leaf (5e-2 in L2, as finetune_tasks). Serve:
   encode (12 flash launches), the kernel encoder against the plain one
   token by token (5e-2) and both against fp32 (recorded), padding rows
   exactly 0, greedy 64 tokens with ``encoder_pad_mask`` (8 decode
   launches a step), cached decode logits against a parallel plain pass
   with the same mask (5e-2/5e-2). The kernels phase holds flash forward
   and backward at its three sites (B=8: 2048 with kv_lens, causal 1023,
   1023x2048 with kv_lens), #8 on its (8, 2048, 768) cross cache with the
   same lengths and on its self cache, and the CE at T 8184, D 768 (the
   kernels line's ``new_path_cases``).
17. ``serve_stream``: cruller_base, bf16, seed-0 weights, the byte-level
   tokenizer padded to 50265, EOS off. (a) 16 seeded uint8 canvases through
   the registered ``cruller_eval_ocr`` task's ``encode_images`` with
   ``device_preprocess`` on (uint8 to the card, normalized there) and off:
   the encoder's input bit-equal, its output bit-equal (or, were the encode
   not to repeat its own bits, within ``serve_model``'s 5e-2/5e-2); the
   bytes and time of each host-to-device copy. (b) one ``cruller_pretrain``
   train step at B=8 with the flag on and off from the same weights and
   batch: losses finite and within 1e-3 relative (bit equality recorded).
   (c) 32 pages with per-page budgets drawn uniformly from 64-256 (numpy,
   seed 17), max_length 257, through ``ops/serving.py::ContinuousBatcher``
   (16 slots, refill 16, pools of 32) and through ``generate`` in batches
   of 16 with the same budgets, in the bf16 and the int8 decode mode: for
   each path pages/s, decode steps, ms a step, tokens a step, first-result
   latency, the device idle share (``device_profile``), launches; the
   batcher's refills and compactions. Gates: every page once; each page's
   tokens equal the batched path's up to the first disagreement, where the
   batched path's own top-2 logit margin (``generate`` replayed on its
   output) is under 0.0625; exact launches (12 flash per encode; per decode
   step 8 of #8, or 4 of #8 and 4 of #9 in int8) and no plain decode
   attention called. The kernels phase holds #8 on the slots' self cache
   ``(16, 640, 768)`` with band masks (a band from mid-split, one with two
   dead leading splits, single keys, a dead row), each against its plain
   version and its own bits.
18. ``loader``: the tar-shard train path at cruller_base, from encoded
   pages to the optimizer step. The port's native library
   (``pixparse_tpu_torch/native``: libjpeg, libpng, the PIL-exact resize)
   is built with g++ from ``native/pixparse_native.cpp``; where the
   machine lacks a libjpeg / libpng / zlib header or library, the phase
   prints one line naming it with ``"skipped"`` and nothing else runs (any
   other build, load or decode failure fails the phase; nothing falls back
   to PIL). One tar of 64 pages, each with a seeded ``cruller_pretrain``
   annotation: 32 PNG pages of 2200x1700 grayscale drawn from seeds
   (``tools/make_page_fixtures.py::synthetic_page``) and written with
   ``zlib`` and ``struct``, and the 4 JPEG fixtures of
   ``pixparse_tpu_torch/tools/page_fixtures/`` 8 times each. (a) Host ms a
   page: native decode of the PNGs, of the JPEGs at full size and
   DCT-scaled for 576x448 (1/2), the legacy transform (native bicubic
   resize) with ``normalize`` true and false, decode plus transform, the
   annotation's tokenization; gates: each PNG decodes to the array that
   was written, bit for bit, and the native decode and resize counters
   equal the page count. (b) The port's ``WdsLoader`` alone at B=16 with
   1, 4 and 8 worker threads: pages decoded a second (also after the
   shuffle buffer has filled) and batches, beside ``os.cpu_count()``. (c)
   ``app.train.main`` (``cruller_pretrain``, cruller_base, bf16, the
   byte-level tokenizer padded to 50265, B=16, 6 steps, 8 loader threads)
   from the shard, with ``--task.device_preprocess`` false and true, then
   ``cruller_pretrain`` through ``train_one_interval`` on seeded in-memory
   batches (train_task's path) in the same call: ms a step and ms waiting
   on the loader (medians of steps 2-6; each step's loss read), the
   device's idle share over steps 2-6 (``torch.profiler``, the card only),
   peak memory. Gates: every page the runs decoded came from the native
   decoder; the flash and CE launches a step equal the in-memory run's;
   each run's step-1 loss finite and within 1e-3 relative of the loss of
   the same batch fed as arrays to a freshly built model of the same seed.

19. ``distributed``: the device mesh (``parallel/mesh.py``) in a child
   started by ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` (its NCCL group ends with the phase; a child that
   fails fails the phase). There ``MeshEnv.initialize`` makes a world of
   one and the mesh (data=1, fsdp=1, model=1), and ``cruller_pretrain`` at
   cruller_base as ``train_task`` builds it (B=16, bf16, the 50265-entry
   tokenizer, seeded in-memory batches) takes 6 steps through the task's
   ``train_step`` FSDP2-wrapped, beside 6 steps of the same task as a
   process alone from the same seed and batch. Gates: step 1's loss within
   1e-3 relative of the process alone's and its gradient norm within 1e-2;
   flash and CE launches a step equal (and non-zero); the mesh run wrapped,
   the other not. Then ``evaluate`` over ``cruller_eval_ocr`` (2 batches of
   16, ``eval_task``'s byte-level setup) through ``app.eval``'s merge in
   each: equal metrics, finite CER/WER, flash and decode launched. The
   record: ms/step (median of steps 2-6), samples/s and peak memory of
   both, and with ``--profile`` each step's device time, idle share and
   the device time of kernels named ``nccl`` (``nccl_ms``; CPU-time tables
   too).
20. ``tensor_parallel``: the mesh's ``model`` axis
   (``parallel/tensor_parallel.py``). (a) Every kernel of the
   model-parallel train step and decode at the shard shapes of model 2 and
   4, each rank's call on its part of the same full tensors: flash forward
   and backward at cruller_base's three sites (B=16, 6 / 3 of 12 heads,
   q/k/v from the rank's own fused projection) and at pix2struct_base's
   encoder and cross sites with the pix2struct phase's ragged kv_lens
   (B=8), the decode kernel (#8) at cruller_base's cross (1009 of 1024
   keys) and self caches (33 of 128) of B=16 on each rank's own contiguous
   caches, the fused CE forward and
   backward on each vocabulary shard (50265 rows -> 25133 / 12567, the
   last shorter) with targets shifted to it, the window kernels at
   donut_base's four stages (B=2, shifted, 2 / 1 to 16 / 8 heads); each
   rank against its plain version (the usual tolerances; a target outside
   a CE shard must give logit 0), the results merged (heads concatenated,
   lse by max and sum, dh summed, dE concatenated, dbias by heads) against
   the unsharded kernel's (#8's within its plain tolerance: a narrower row
   takes another tile and key split); rank 0's shard timed beside its plain
   version, the library call and its bound. (b) A child started by
   ``torch.distributed.run --nproc_per_node 2`` whose two ranks share the
   card over gloo (NCCL refuses two ranks on one device), each run on rank
   0 alone, then on both at mesh (1,1,2), bf16, dropout 0 (a model rank
   draws FFN masks at its shard's shape): ``cruller_pretrain`` at
   cruller_base (B=16, 2 steps) and ``pix2struct_pretrain`` at
   pix2struct_base (B=8, the pix2struct phase's pages, 2 steps), gated by
   step 1's loss within 1e-3 relative and its gradient norm within 1e-2 of
   the process alone's, the same losses on both ranks, each rank's flash
   and CE launches a step equal to the process alone's and non-zero; then
   cruller_base decoding through the registered ``cruller_eval_ocr``
   task's ``setup`` (the model cut over ``model``) and ``generate``: B=16
   seeded pages, 32 new tokens, EOS off, gated by the two ranks' tokens
   equal, the prefill's and every step's logits teacher-forced along
   alone's tokens within 5e-2 of alone's, each rank's #1/#2 launches an
   encode and #8 launches a run equal to alone's and non-zero; recorded
   the share of tokens equal to alone's, encode ms, decode ms a step and
   each rank's peak memory.

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
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
PHASES = ("device", "kernels", "probes", "serve_model", "serve_task", "serve_donut",
          "eval_task", "train_model", "train_donut", "train_task", "pretrained_train",
          "finetune_tasks", "beam_eval", "sample", "naive", "large", "pix2struct",
          "serve_stream", "loader", "distributed", "tensor_parallel")
MODEL_NEW_TOKENS = 128  # serve_model: fixed decode budget (EOS disabled)
TASK_NEW_TOKENS = 64  # serve_task: generation cap after the one-token prompt
TRAIN_STEPS = 6  # train_model: steps on the repeated batch (the first one warms up)
BART_VOCAB = 50265  # cruller_base's published vocabulary (facebook/bart-base)
DONUT_VOCAB = 57525  # donut_base's (its mBART decoder's table)
DONUT_NEW_TOKENS = 64  # serve_donut: fixed decode budget (EOS disabled)
DONUT_TRAIN_STEPS = 3  # train_donut: steps under each remat mode (the first one warms up)
BYTE_IDS = (4, 260)  # the byte-level tokenizer's 256 byte tokens
FINETUNE_B = 8  # finetune_tasks (a): CORD finetune batch, 2 batches an interval, 2 intervals
FINETUNE_TEXT = 511  # the finetune collates' 512 tokens, shifted
# (a)'s vocabulary: BART_VOCAB, the two pretrain tokens, then the CORD
# replay's 55 new ones (finetune_tasks checks it)
CORD_FINETUNE_VOCAB = BART_VOCAB + 57
BEAM_K = 4  # beam_eval: beams per page
LARGE_B = 8  # large: serving and training batch at cruller_large
# pix2struct: page sizes (H, W), page i of the batch taking size i % 4; at
# pix2struct_base's 2048 patches of 16 they give 2028 / 2014 / 1980 / 1989
# real patches (variable_grid), so kv_lens is ragged and ends off a tile
PIX2STRUCT_PAGES = ((600, 800), (3508, 2480), (4000, 300), (1700, 1300))
PIX2STRUCT_B = 8  # pix2struct: train and serve batch
PIX2STRUCT_STEPS = 4  # pix2struct: train steps on the repeated batch (the first one warms up)
# serve_stream: continuous batching against batched decode at cruller_base
STREAM_PAGES = 32  # the stream's pages (the whole script must stay within its time)
STREAM_SLOTS = 16
STREAM_MAX_LENGTH = 257  # prompt 1 + 256
STREAM_BUDGETS = (64, 256)  # per-page budgets, uniform (inclusive)
# the slots' self-cache columns at STREAM_MAX_LENGTH, by the batcher's rule:
# max(2 * 257, 257 + 32 * 2) = 514, rounded up to 128
STREAM_C = 640
STREAM_TRAIN_B = 8  # serve_stream (b): the train step's batch

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


@contextlib.contextmanager
def nan_default_init(torch):
    """PyTorch's default parameter init (``kaiming_uniform_``, ``uniform_``,
    ``normal_`` of ``torch.nn.init``, which every ``nn.Linear``,
    ``nn.Embedding`` and ``nn.Conv2d`` calls when it is built) fills NaN
    instead of drawing. Every model of the port draws all of its parameters
    again from a seeded generator (``init_weights``) or loads them, so the
    weights are the same bits, a model builds in a fraction of the time
    (cruller_large: ~5 s of draws on the host), and a parameter that
    neither step reached stays NaN and fails the phase's gates."""
    init = torch.nn.init
    saved = {n: getattr(init, n) for n in ("kaiming_uniform_", "uniform_", "normal_")}
    for n in saved:
        setattr(init, n, lambda t, *args, **kwargs: init.constant_(t, math.nan))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(init, n, fn)


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
    ] + flash_new_cases(torch) + flash_finetune_cases(torch) + flash_large_cases(torch) + (
        flash_pix2struct_cases(torch))


def flash_pix2struct_cases(torch):
    """The pix2struct phase's train step: pix2struct_base's encoder (B=8,
    2048 patches, 12 heads) with the batch's kv_lens, its decoder's causal
    self-attention (1023 tokens) and its cross-attention over the encoder
    with the same kv_lens."""
    bf = torch.bfloat16
    lens = pix2struct_lens()
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("p2s_encode_b8_l2048_kv_lens", PIX2STRUCT_B, 2048, 2048, 12, 64, bf, False, lens),
        ("p2s_self_causal_b8_l1023", PIX2STRUCT_B, 1023, 1023, 12, 64, bf, True, None),
        ("p2s_cross_b8_lq1023_lk2048_kv_lens", PIX2STRUCT_B, 1023, 2048, 12, 64, bf, False, lens),
    ]


def flash_large_cases(torch):
    """The large phase's train step: cruller_large's encoder (B=8, 2509
    tokens, 16 heads) and its decoder's two sites (1023 tokens, causal self
    and cross over the encoder)."""
    bf = torch.bfloat16
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("large_encode_b8_l2509_h16", LARGE_B, 2509, 2509, 16, 64, bf, False, None),
        ("large_self_causal_b8_l1023_h16", LARGE_B, 1023, 1023, 16, 64, bf, True, None),
        ("large_cross_b8_lq1023_lk2509_h16", LARGE_B, 1023, 2509, 16, 64, bf, False, None),
    ]


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


def flash_finetune_cases(torch):
    """finetune_tasks (a)'s decoder sites: B=8, the collates' 511 tokens
    (the 512 of the collate, shifted), against the 1009 encoder tokens."""
    bf = torch.bfloat16
    # name, B, Lq, Lk, H, D, dtype, causal, kv_lens
    return [
        ("finetune_self_causal_b8_l511", FINETUNE_B, FINETUNE_TEXT, FINETUNE_TEXT, 12, 64, bf,
         True, None),
        ("finetune_cross_b8_lq511_lk1009", FINETUNE_B, FINETUNE_TEXT, 1009, 12, 64, bf, False, None),
    ]


def stream_bands(kind, B=STREAM_SLOTS):
    """``serve_stream``'s self-cache masks: each row's live keys a band
    ``[lo, hi)`` of the ``STREAM_C`` columns (where its slot was refilled, up
    to the shared column), as (lo, hi) per row. With 16 rows of 768 bf16
    (``decode_plan``: splits of 40 keys) a band that starts at 85 leaves two
    leading splits of its row dead and a third live from mid-split."""
    if kind == "mid_split":
        return tuple((40 * (b % 8) + 20, 40 * (b % 8) + 20 + 37 * (b + 1)) for b in range(B))
    if kind == "two_dead_splits":
        return tuple((85 + 3 * b, STREAM_C - 40 * (b % 4)) for b in range(B))
    if kind == "one_key":
        return tuple((k, k + 1) for k in (40 * b + (7 * b) % 40 for b in range(B)))
    # a row fully dead (a slot with no page), the rest bands to the column
    return tuple((0, 0) if b == 3 else (17 * b, 600) for b in range(B))


def decode_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    self_pad = -(-(1 + TASK_NEW_TOKENS) // 128) * 128  # the main path's self cache
    # name, B, Lk, n_valid (None = ragged self-cache mask; a list: per row; a
    # tuple: a band (lo, hi) per row), H, D, dtype
    return [
        ("cross_b16_lk1024_valid1009", 16, 1024, 1009, 12, 64, bf),
        (f"self_b16_lk{self_pad}_valid{self_pad // 2}", 16, self_pad, self_pad // 2, 12, 64, bf),
        ("self_ragged_with_dead_row", 16, 1024, None, 12, 64, bf),
        ("test_width_d32", 3, 256, None, 2, 32, bf),
        ("fp32_b4_lk333", 4, 384, 333, 12, 64, f32),
        ("donut_cross_b8_lk4864_valid4800", 8, 4864, 4800, 16, 64, bf),
        # Lk not a multiple of the kernel's 10-key tile (H*D = 768), row 1 dead
        ("ragged_lk997_dead_row", 16, 997, None, 12, 64, bf),
        # beam_eval: B * K rows of the cruller_base cross cache
        ("beam_cross_b64_lk1024_valid1009", 16 * BEAM_K, 1024, 1009, 12, 64, bf),
        # pix2struct: its cross cache, each row's real patches valid; its self cache
        ("p2s_cross_b8_lk2048_kv_lens", PIX2STRUCT_B, 2048, pix2struct_lens(), 12, 64, bf),
        (f"p2s_self_b8_lk{self_pad}_valid{self_pad // 2}", PIX2STRUCT_B, self_pad, self_pad // 2,
         12, 64, bf),
    ] + [  # serve_stream: the slots' self cache, band masks
        (f"stream_self_b16_lk{STREAM_C}_band_{kind}", STREAM_SLOTS, STREAM_C, stream_bands(kind),
         12, 64, bf)
        for kind in ("mid_split", "two_dead_splits", "one_key", "dead_row")
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


def donut_ln_sites(B=2, model_name="donut_base"):
    """``{(rows, width): launches}`` of the LayerNorms in one donut_base
    train step at batch B, from the model's geometry: the patch embedding's
    norm at stage 0; two per Swin block at its stage's map; each patch
    merging's over 4C at the merged map; the final norm, if the encoder has
    one; the decoder's three per layer, its embedding's and its final one
    over B x (text length - 1) rows."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs

    enc, dec, _ = resolve_cruller_cfgs(get_model_config(model_name), vocab_size=DONUT_VOCAB)
    sites = {}

    def add(rows, width, n):
        sites[(rows, width)] = sites.get((rows, width), 0) + n

    h, w, C = enc.img_size[0] // enc.patch_size, enc.img_size[1] // enc.patch_size, enc.embed_dim
    add(B * h * w, C, 1)
    for stage, depth in enumerate(enc.depths):
        if stage:
            h, w = -(-h // 2), -(-w // 2)
            add(B * h * w, 4 * C, 1)
            C *= 2
        add(B * h * w, C, 2 * depth)
    if enc.final_norm:
        add(B * h * w, C, 1)
    add(B * (dec.max_position_embeddings - 1), dec.d_model,
        3 * dec.decoder_layers + int(dec.layernorm_embedding) + int(dec.add_final_layer_norm))
    return sites


DONUT_LN_NAMES = {  # the donut_base B=2 step's LayerNorm shapes
    (614400, 128): "swin_stage0", (153600, 256): "swin_stage1", (153600, 512): "swin_merge1",
    (38400, 512): "swin_stage2", (38400, 1024): "swin_merge2", (9600, 1024): "swin_stage3",
    (9600, 2048): "swin_merge3", (3070, 1024): "decoder",
}


def ln_cases(torch):
    """Every LayerNorm shape of the donut_base B=2 train step (2560x1920,
    text 1535) in bf16, each with its launches per step; Swin stages 0 and
    2, the last merge and the decoder in fp32 too."""
    sites = donut_ln_sites()
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[-1]
        for (R, D), n in sites.items():
            if dt == torch.float32 and (R, D) not in ((614400, 128), (38400, 512), (9600, 2048),
                                                      (3070, 1024)):
                continue
            cases.append((f"{DONUT_LN_NAMES.get((R, D), 'site')}_r{R}_d{D}_{tag}", R, D, dt, n))
    return cases


def q8_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, B, Lk (cache length), mask (valid keys; "ragged": ragged with a
    # dead row; "split_holes": masked runs across every split's end), H, D, dtype
    return [
        ("cross_b16_lk1024_valid1009", 16, 1024, 1009, 12, 64, bf),
        ("donut_cross_b8_lk4864_valid4800", 8, 4864, 4800, 16, 64, bf),
        # beam_eval's int8 run: B * K rows of the cruller_base cross cache
        ("beam_cross_b64_lk1024_valid1009", 16 * BEAM_K, 1024, 1009, 12, 64, bf),
        ("ragged_with_dead_row_b16_lk1024", 16, 1024, "ragged", 12, 64, bf),
        ("ragged_lk997_dead_row_b4", 4, 997, "ragged", 12, 64, bf),
        ("split_ends_in_masked_runs_b4_lk1024", 4, 1024, "split_holes", 12, 64, bf),
        ("test_width_d32_b3_lk256", 3, 256, "ragged", 2, 32, bf),
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
    ] + flash_new_cases(torch, backward=True) + flash_finetune_cases(torch) + flash_large_cases(
        torch) + flash_pix2struct_cases(torch)


def ce_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # name, T, V, D, dtype, share of ignored tokens (or "collate": collate_ignored)
    return [
        ("train_t16368_v50265_d768", 16 * 1023, BART_VOCAB, 768, bf, 0.3),
        # the backward's vocabulary chunks at T 16368 are 8192 rows: one full
        # chunk and one row
        ("chunk_edge_t16368_v8193_d768", 16 * 1023, 8193, 768, bf, 0.3),
        ("all_ignored_t512_v50265_d768", 512, BART_VOCAB, 768, bf, 1.0),
        ("donut_t3070_v57525_d1024", 2 * 1535, DONUT_VOCAB, 1024, bf, 0.3),
        ("test_width_t300_v517_d64", 300, 517, 64, bf, 0.2),
        ("fp32_t200_v1001_d256", 200, 1001, 256, f32, 0.2),
        # finetune_tasks (a): B=8 rows of 511 at the vocabulary the CORD
        # replay grows, ignored where the finetune collates put -100
        ("finetune_cord_t4088_v50322_d768", FINETUNE_B * FINETUNE_TEXT, CORD_FINETUNE_VOCAB, 768,
         bf, "collate"),
        # the large phase's train step: bart-large's width over its vocabulary
        ("large_t8184_v50265_d1024", LARGE_B * 1023, BART_VOCAB, 1024, bf, 0.3),
        # the pix2struct phase's: bart-base's width
        ("p2s_t8184_v50265_d768", PIX2STRUCT_B * 1023, BART_VOCAB, 768, bf, 0.3),
    ]


def collate_ignored(target, L, gen):
    """Masks ``target`` as the finetune collates do, in rows of ``L``: a
    prompt prefix (DocVQA's question; none to 63 positions) and the pad tail
    after each row's text (an eighth of ``L`` to all of it) -> -100."""
    import torch

    rows = target.view(-1, L)
    pos = torch.arange(L)[None]
    prompt = torch.randint(0, 64, (rows.shape[0], 1), generator=gen)
    end = torch.randint(L // 8, L + 1, (rows.shape[0], 1), generator=gen)
    rows[(pos < prompt) | (pos >= end)] = -100
    return target


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
    if ignored == "collate":
        target = collate_ignored(target, FINETUNE_TEXT, gen)
    else:
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
    name, R, D, dt, per_step = case
    _, _, bw = peaks
    x = (torch.randn(R, D, device="cuda", generator=gen) * 2 + 0.5).to(dt)
    w = 1 + 0.3 * torch.randn(D, device="cuda", generator=gen)
    b = 0.2 * torch.randn(D, device="cuda", generator=gen)
    dy = torch.randn(R, D, device="cuda", generator=gen).to(dt)
    eps = 1e-5
    elt = x.element_size()
    tag = str(dt).split(".")[-1]
    atol, rtol = TOL[tag]
    common = dict(case=name, shape=[R, D], dtype=str(dt), launches_per_step=per_step)

    y = lnm.layer_norm_fwd(x, w, b, eps)
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(lnm.layer_norm_fwd(x, w, b, eps), y))
    y_ref = lnm.layer_norm_fwd_plain(x, w, b, eps)
    err, ok = close(y, y_ref, atol, rtol)
    idx = torch.cuda.current_device()
    code = 1 if dt == torch.bfloat16 else 0
    lanes, _, rows_a_thread = lnm.layer_norm_config(D, elt)
    per_sm = lnm._blocks_per_sm("fwd", idx, code, D)
    G, n_groups, n_blocks = lnm.layer_norm_plan(R, D, elt, lnm._sm_count(idx), per_sm)
    fwd = dict(common, max_abs_err=err, tol=[atol, rtol], ok=ok and repeatable,
               repeatable=repeatable,
               plan={"blocks": n_blocks, "blocks_per_sm": per_sm, "groups": n_groups,
                     "group_rows": G, "rows_a_thread": rows_a_thread, "lanes_a_row": lanes})
    del y, y_ref
    fwd.update(bound_ms=(2 * elt * R * D + 8 * D) / bw * 1e3, bound_by="bytes")
    fwd["ms"] = timer.median_ms(lambda: lnm.layer_norm_fwd(x, w, b, eps))
    fwd["plain_ms"] = timer.median_ms(lambda: lnm.layer_norm_fwd_plain(x, w, b, eps), n=5, warmup=1)
    wl, bl = w.to(dt), b.to(dt)
    fwd["library_ms"] = timer.median_ms(lambda: F.layer_norm(x, (D,), wl, bl, eps))
    fwd["device_ms"] = timer.median_ms(lambda: lnm.layer_norm_fwd(x, w, b, eps), busy=True)
    fwd["library_device_ms"] = timer.median_ms(lambda: F.layer_norm(x, (D,), wl, bl, eps), busy=True)
    fwd.update(speed_shares(fwd), device_bound_share=fwd["bound_ms"] / fwd["device_ms"],
               device_ratio_to_library=fwd["device_ms"] / fwd["library_device_ms"])

    dx, dw, db = lnm.layer_norm_bwd(x, w, dy, eps)
    torch.cuda.synchronize()
    again = lnm.layer_norm_bwd(x, w, dy, eps)
    repeatable = all(bool(torch.equal(u, v)) for u, v in zip((dx, dw, db), again))
    del again
    plan = lnm.layer_norm_plan(R, D, elt, lnm._sm_count(idx), lnm._blocks_per_sm("bwd", idx, code, D))
    # dweight / dbias summed as the kernels sum them (per-block partials)
    dx_ref, dw_ref, db_ref = lnm.layer_norm_bwd_plain(
        x, w, dy, eps, row_ranges=lnm.layer_norm_bwd_row_ranges(R, *plan))
    dx_err, dx_ok = close(dx, dx_ref, atol, rtol)
    # dweight / dbias: sums over R rows, each held as one row (L2 error
    # within rtol of its norm)
    dw_err, dw_rel, dw_ok = rows_close(dw[None], dw_ref[None], rtol)
    db_err, db_rel, db_ok = rows_close(db[None], db_ref[None], rtol)
    bwd = dict(common, max_abs_err=max(dx_err, dw_err, db_err), dx_max_abs_err=dx_err,
               dw_rel_err=dw_rel, db_rel_err=db_rel, tol=[atol, rtol, "dw/db row L2", rtol],
               ok=dx_ok and dw_ok and db_ok and repeatable, repeatable=repeatable,
               plan_group_rows_groups_blocks=list(plan))
    del dx, dw, db, dx_ref, dw_ref, db_ref
    bwd.update(bound_ms=(3 * elt * R * D + 12 * D) / bw * 1e3, bound_by="bytes")
    bwd["ms"] = timer.median_ms(lambda: lnm.layer_norm_bwd(x, w, dy, eps))
    bwd["plain_ms"] = timer.median_ms(lambda: lnm.layer_norm_bwd_plain(x, w, dy, eps), n=5, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (x, wl, bl)]
    out = F.layer_norm(leaves[0], (D,), leaves[1], leaves[2], eps)
    lib = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)
    bwd["library_ms"] = timer.median_ms(lib)
    bwd["device_ms"] = timer.median_ms(lambda: lnm.layer_norm_bwd(x, w, dy, eps), busy=True)
    bwd["library_device_ms"] = timer.median_ms(lib, busy=True)
    bwd.update(speed_shares(bwd))
    return fwd, bwd


def check_q8(torch, F, da, timer, peaks, gen, case):
    name, B, Lk, mask_kind, H, D, dt = case
    peak_bf16, peak_f32, bw = peaks
    HD = H * D
    idx = torch.cuda.current_device()
    by_heads = da.decode_q8_by_heads(B, Lk, H, da._sm_count(idx))
    plan = da.decode_plan_q8(B, Lk, H, D, da._sm_count(idx),
                             da._q8_blocks_per_sm(idx, 1 if dt == torch.bfloat16 else 0, D))
    split = None if by_heads else plan[1]  # the per-head kernel's softmax is unsplit
    q = torch.randn(B, 1, HD, generator=gen).to("cuda", dt)
    n_valid = mask_kind if isinstance(mask_kind, int) else None
    if mask_kind == "ragged":
        mask = ragged_mask(torch, B, Lk, gen)
    elif mask_kind == "split_holes":  # the last keys of every split and the first of the next
        mask = torch.ones(B, Lk, dtype=torch.bool)
        for end in range(plan[1], Lk, plan[1]):
            mask[:, end - 5:end + 7] = False
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
    repeatable = bool(torch.equal(da.decode_attention_q8(*args, num_heads=H), o))
    o_ref = da.decode_attention_q8_plain(*args, num_heads=H, split_keys=split)
    err, ok = close(o, o_ref, 1e-2, 1e-2)
    dead = ~mask.any(dim=1)
    if bool(dead.any()):
        ok = ok and bool((o[dead] == 0).all())
    nvk = int(mask.sum())
    rec = dict(case=name, shape=[B, Lk, H, D], dtype=str(dt), max_abs_err=err,
               tol=[1e-2, 1e-2], ok=ok and repeatable, repeatable=repeatable, valid_keys=nvk,
               dead_rows=int(dead.sum()), path="heads" if by_heads else "splits",
               plan_kt_split_keys_n_split_slots=None if by_heads else list(plan))
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
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    rec["library_ms"] = timer.median_ms(lib)
    kf, vf = (t.reshape(B, Lk, HD) for t in deq)
    bf16_kernel = lambda: da.decode_attention(q, kf, vf, mask, num_heads=H)
    rec["bf16_kernel_ms"] = timer.median_ms(bf16_kernel)
    rec["device_ms"] = timer.median_ms(lambda: da.decode_attention_q8(*args, num_heads=H),
                                       busy=True)
    rec["library_device_ms"] = timer.median_ms(lib, busy=True)
    rec["bf16_kernel_device_ms"] = timer.median_ms(bf16_kernel, busy=True)
    rec.update(speed_shares(rec))
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
    last = [time.perf_counter()]

    def note_case(kernel, rec):
        """Progress record of one case, with ``wall_s``: the seconds since
        the previous record (its inputs, checks and timings)."""
        now = time.perf_counter()
        rec["wall_s"], last[0] = now - last[0], now
        note({"kernel": kernel, **rec})

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
        note_case("flash_attention_fwd", rec)
        if not rec["ok"]:
            failed.append(f"flash_attention_fwd/{name}")
        del qkv, q, k, v, o, lse, o_ref, lse_ref

    band_gen = torch.Generator().manual_seed(17)  # the band cases' own draws
    for name, B, Lk, n_valid, H, D, dt in decode_cases(torch):
        HD = H * D
        g = band_gen if isinstance(n_valid, tuple) else gen
        q = torch.randn(B, 1, HD, generator=g).to("cuda", dt)
        k = torch.randn(B, Lk, HD, generator=g).to("cuda", dt)
        v = torch.randn(B, Lk, HD, generator=g).to("cuda", dt)
        if n_valid is None:
            mask = ragged_mask(torch, B, Lk, gen).cuda()
        elif isinstance(n_valid, tuple):  # a band of live keys per row
            lo, hi = (torch.tensor(x)[:, None] for x in zip(*n_valid))
            cols = torch.arange(Lk)[None]
            mask = ((cols >= lo) & (cols < hi)).cuda()
        elif isinstance(n_valid, list):  # valid keys per row
            mask = (torch.arange(Lk)[None] < torch.tensor(n_valid)[:, None]).cuda()
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
        note_case("decode_attention", rec)
        if not rec["ok"]:
            failed.append(f"decode_attention/{name}")
        del q, k, v, o, o_ref

    for case in flash_bwd_cases(torch):
        rec = check_flash_bwd(torch, F, fa, timer, peaks, gen, case)
        results["flash_attention_bwd"].append(rec)
        note_case("flash_attention_bwd", rec)
        if not rec["ok"]:
            failed.append(f"flash_attention_bwd/{case[0]}")
        torch.cuda.empty_cache()
    for case in ce_cases(torch):
        fwd, bwd = check_fused_ce(torch, F, loss, timer, peaks, gen, case)
        for kname, rec in (("fused_ce_fwd", fwd), ("fused_ce_bwd", bwd)):
            results[kname].append(rec)
            note_case(kname, rec)
            if not rec["ok"]:
                failed.append(f"{kname}/{case[0]}")
        torch.cuda.empty_cache()
    cuda_gen = torch.Generator(device="cuda").manual_seed(0)
    for case in window_cases(torch):
        rec = check_window(torch, F, wa, timer, peaks, cuda_gen, case)
        results["window_attention"].append(rec)
        note_case("window_attention", rec)
        if not rec["ok"]:
            failed.append(f"window_attention/{case[0]}")
        torch.cuda.empty_cache()
    for case in window_bwd_cases(torch):
        rec = check_window_bwd(torch, F, wa, timer, peaks, cuda_gen, case)
        results["window_attention_bwd"].append(rec)
        note_case("window_attention_bwd", rec)
        if not rec["ok"]:
            failed.append(f"window_attention_bwd/{case[0]}")
        torch.cuda.empty_cache()
    for case in ln_cases(torch):
        fwd, bwd = check_ln(torch, F, lnm, timer, peaks, cuda_gen, case)
        for kname, rec in (("layer_norm_fwd", fwd), ("layer_norm_bwd", bwd)):
            results[kname].append(rec)
            note_case(kname, rec)
            if not rec["ok"]:
                failed.append(f"{kname}/{case[0]}")
        torch.cuda.empty_cache()
    # a donut_base B=2 step's LayerNorm work: launches x time, over its shapes
    step = {}
    for kname in ("layer_norm_fwd", "layer_norm_bwd"):
        recs = [r for r in results[kname] if r["dtype"] == "torch.bfloat16"]
        step[kname] = {k: sum(r["launches_per_step"] * r[k] for r in recs)
                       for k in ("ms", "device_ms", "bound_ms", "library_ms")}
        step[kname]["launches"] = sum(r["launches_per_step"] for r in recs)
    note({"layer_norm_step_ms": step})
    results["layer_norm_step"] = step
    for case in q8_cases(torch):
        rec = check_q8(torch, F, da, timer, peaks, gen, case)
        results["decode_attention_q8"].append(rec)
        note_case("decode_attention_q8", rec)
        if not rec["ok"]:
            failed.append(f"decode_attention_q8/{case[0]}")
    for case in mxu_cases():
        rec = check_mxu(torch, mp, timer, peaks, case)
        results["mxu_dots"].append(rec)
        note_case("mxu_dots", rec)
        if not rec["ok"]:
            failed.append(f"mxu_dots/{case[0]}")
        torch.cuda.empty_cache()
    for case in band_cases():
        rec = check_band(torch, F, wb, wa, timer, peaks, cuda_gen, case)
        results["banded_attention"].append(rec)
        note_case("banded_attention", rec)
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
# the kernels line's records of the new paths' shapes, beside each main case
P2S_FLASH_CASES = ("p2s_encode_b8_l2048_kv_lens", "p2s_self_causal_b8_l1023",
                   "p2s_cross_b8_lq1023_lk2048_kv_lens")
NEW_PATH_CASES = {
    "flash_attention_fwd": ("large_encode_b8_l2509_h16", "large_self_causal_b8_l1023_h16",
                            "large_cross_b8_lq1023_lk2509_h16") + P2S_FLASH_CASES,
    "flash_attention_bwd": ("large_encode_b8_l2509_h16", "large_self_causal_b8_l1023_h16",
                            "large_cross_b8_lq1023_lk2509_h16") + P2S_FLASH_CASES,
    "fused_ce_fwd": ("large_t8184_v50265_d1024", "p2s_t8184_v50265_d768"),
    "fused_ce_bwd": ("large_t8184_v50265_d1024", "p2s_t8184_v50265_d768"),
    "decode_attention": ("beam_cross_b64_lk1024_valid1009", "p2s_cross_b8_lk2048_kv_lens",
                         "p2s_self_b8_lk128_valid64", "stream_self_b16_lk640_band_mid_split",
                         "stream_self_b16_lk640_band_two_dead_splits",
                         "stream_self_b16_lk640_band_one_key", "stream_self_b16_lk640_band_dead_row"),
    "decode_attention_q8": ("beam_cross_b64_lk1024_valid1009",),
}
LINE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# the kernels each main path must launch
SERVE_KERNELS = ("flash_attention_fwd", "decode_attention")
EVAL_KERNELS = {  # eval_task's two runs
    "donut_base": ("window_attention", "decode_attention"),
    "cruller_base_int8": ("flash_attention_fwd", "decode_attention", "decode_attention_q8"),
}
PROBE_OWN_KERNELS = ("mxu_dots", "banded_attention")  # #16, #17: only the probes run them
BUSY_TIMED = ("decode_attention_q8", "layer_norm_fwd", "layer_norm_bwd")  # with device_ms in the line
PROBE_KERNELS = PROBE_OWN_KERNELS + ("window_attention",)  # probes' run
PRETRAINED_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")
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


def device_profile(torch, fn, tag, wall_ms, cpu=True, match=None, cpu_table=False):
    """``torch.profiler`` over one call of ``fn``: device time by kernel
    (table in ``OUT_DIR/profile_<tag>.txt``), and the device's idle share of
    ``wall_ms``, the same call's time measured without the profiler.
    ``cpu=False`` traces the card's activity only: a run of ~100k launches
    then costs seconds to trace instead of a minute or more. ``match``: also
    the device time of the kernels whose name holds that word
    (``<match>_ms``, case ignored). ``cpu_table``: also the table by host
    time (``OUT_DIR/profile_<tag>_cpu.txt``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        sync(torch)
    events = prof.key_averages()
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40))
    if cpu_table:
        with open(os.path.join(OUT_DIR, f"profile_{tag}_cpu.txt"), "w") as fh:
            fh.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    out = {
        "wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], dev_ms(e), e.count] for e in top],
    }
    if match:
        out[f"{match}_ms"] = sum(dev_ms(e) for e in kernels if match in e.key.lower())
    return out


def cached_vs_parallel(torch, model, enc, ids, encoder_pad_mask=None):
    """Logits of a prefill plus single-token decode steps over ``ids`` (the
    decode-attention kernel on the card) against one teacher-forced parallel
    pass over the same tokens with plain attention (no kernel); both with
    the encoder's pad mask where one is given."""
    from pixparse_tpu_torch.models.bart import KVCache

    kw = dict(encoder_pad_mask=encoder_pad_mask)
    cache = KVCache(max_len=ids.shape[1])
    steps = [model.decode(ids[:, :1], enc, cache, mode="prefill", **kw)[:, -1]]
    for t in range(1, ids.shape[1]):
        steps.append(model.decode(ids[:, t:t + 1], enc, cache, mode="decode", **kw)[:, -1])
    model.attn_impl = "xla"
    parallel = model.decode(ids, enc, mode="train", **kw)
    model.attn_impl = "flash"
    return close(torch.stack(steps, 1), parallel, 5e-2, 5e-2)


def encoder_vs_fp32(torch, model, image_input, encoded):
    """Each of ``encoded``'s bf16 encoder outputs (e.g. the kernel path's and
    the plain path's) against one fp32 plain forward of the same weights on
    the same input: max abs error, and each token's L2 error over its L2
    norm (worst and mean over tokens whose reference is not 0)."""
    import copy

    with torch.inference_mode(False), torch.no_grad():
        ref = copy.deepcopy(model).float()
        ref.attn_impl = "xla"
        if isinstance(image_input, dict):
            image_input = {k: v.float() if v.is_floating_point() else v
                           for k, v in image_input.items()}
        else:
            image_input = image_input.float()
        want = ref.encode(image_input)
        del ref
        out = {}
        for name, got in encoded.items():
            diff = got.float() - want
            err, scale = torch_norm(diff), torch_norm(want)
            live = scale > 0
            rel = err[live] / scale[live]
            out[name] = {"max_abs_err": float(diff.abs().max()),
                         "worst_token_rel_err": float(rel.max()),
                         "mean_token_rel_err": float(rel.mean()),
                         "dead_tokens_nonzero": int((err[~live] > 0).sum())}
        del want
    names = list(encoded)
    if len(names) == 2:
        a, b = (out[n]["worst_token_rel_err"] for n in names)
        out[f"{names[0]}_over_{names[1]}_worst"] = a / b if b else None
    return out


def phase_serve_model(torch, new_tokens=MODEL_NEW_TOKENS, B=16, model_name="cruller_base",
                      device="cuda", profile=False, phase="serve_model", token_l2=False):
    """``phase``: the name the record and its failures carry (``large``
    serves cruller_large through here). ``token_l2``: the flash encoder is
    held to the plain one token by token, each token's L2 error within 5e-2
    of its L2 norm, as ``serve_donut`` holds its deep bf16 encoder, instead
    of element by element; both encoders are then also measured against an
    fp32 plain forward (``encode_vs_fp32``, recorded, not gated)."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs
    from pixparse_tpu_torch.ops.generation import generate

    cfg = get_model_config(model_name)
    vit_cfg, bart_cfg, _ = resolve_cruller_cfgs(cfg, vocab_size=50265)
    gen = torch.Generator().manual_seed(0)
    model = Cruller(vit_cfg, bart_cfg, attn_impl="flash").init_weights(gen)
    model = model.to(device, torch.bfloat16).eval()
    images = synthetic_pages(torch, B, *vit_cfg.img_size, gen).to(device)
    on_card = torch.cuda.is_available()

    with torch.inference_mode():
        enc = model.encode(images)  # warm-up (cuBLAS handles, allocator)
        sync(torch)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        enc = model.encode(images)
        sync(torch)
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = read_counts()
        peak_enc = torch.cuda.max_memory_allocated() if on_card else 0
        model.attn_impl = "xla"
        enc_plain = model.encode(images)
        model.attn_impl = "flash"
        enc_err, enc_ok = close(enc, enc_plain, 5e-2, 5e-2)
        vs_fp32 = None
        if token_l2:
            _, enc_row_err, enc_ok = rows_close(enc, enc_plain, 5e-2)
            vs_fp32 = encoder_vs_fp32(torch, model, images, {"kernel": enc, "plain": enc_plain})
        del enc_plain

        prompt = torch.zeros(B, 1, dtype=torch.long, device=device)  # <s>
        # eos disabled (-1): every page decodes the whole budget, so the
        # step count and the per-step time are fixed by construction
        kwargs = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1)
        generate(model, enc, prompt, **dict(kwargs, max_length=9))  # warm-up
        sync(torch)
        if on_card:  # the serving peak: the encode's or the decode's, not the plain check's
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = generate(model, enc, prompt, **kwargs)
        sync(torch)
        gen_s = time.perf_counter() - t0
        dec_launches = read_counts()
        peak_gb = max(peak_enc, torch.cuda.max_memory_allocated()) / 2 ** 30 if on_card else None
        dec_err, dec_ok = cached_vs_parallel(torch, model, enc, res.tokens[:, :16])
        if profile:
            tag = "" if phase == "serve_model" else f"{phase}_"
            prof = {
                "encode": device_profile(
                    torch, lambda: model.encode(images), f"{tag}encode", encode_ms),
                "generate": device_profile(
                    torch, lambda: generate(model, enc, prompt, **kwargs), f"{tag}generate",
                    gen_s * 1e3),
            }
    steps = res.steps
    rec = {
        "phase": phase, "model": model_name, "batch": B, "dtype": "bfloat16",
        "vocab": bart_cfg.vocab_size, "encoder_tokens": vit_cfg.num_tokens,
        "new_tokens": new_tokens, "decode_steps": steps,
        "encode_launches": enc_launches, "generate_launches": dec_launches,
        "encode_flash_vs_plain_max_abs_err": enc_err,
        **({"encode_flash_vs_plain_worst_token_rel_err": enc_row_err,
            "encode_tol": ["token L2", 5e-2], "encode_vs_fp32": vs_fp32}
           if token_l2 else {"encode_tol": [5e-2, 5e-2]}),
        "decode_cached_vs_parallel_max_abs_err": dec_err, "decode_tol": [5e-2, 5e-2],
        "encode_ms": encode_ms, "generate_ms": gen_s * 1e3,
        "decode_ms_per_step": gen_s * 1e3 / max(steps, 1),
        "pages_per_s": B / (encode_ms / 1e3 + gen_s),
        "tokens_per_s": B * new_tokens / gen_s, "peak_memory_gib": peak_gb,
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
        raise SystemExit(f"{phase} failed: " + "; ".join(problems))
    rec["launches"] = {k: enc_launches[k] + dec_launches[k] for k in enc_launches}
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


def saved_tokenizer(path, vocab, specials=True):
    """The byte-level tokenizer, the OCR tasks' special tokens (those the
    pretrain phase adds) at the ids their replay gives them, then filler
    tokens up to ``vocab`` entries, saved to ``path`` (the task's tokenizer
    name). ``specials=False``: ``vocab`` entries without the special tokens,
    as a published tokenizer is before the task adds its own."""
    from pixparse_tpu_torch.task.common import SPECIAL_TOKENS_FROM_PRETRAIN, add_special_tokens
    from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer

    tokenizer = ByteLevelTokenizer()
    if specials:
        add_special_tokens(tokenizer, SPECIAL_TOKENS_FROM_PRETRAIN)
    tokenizer.add_tokens([f"<filler_{i}>" for i in range(vocab - len(tokenizer))])
    tokenizer.save_pretrained(path)
    return path


def eval_task_setup(torch, model_name, mode, tok_dir, device, env=None):
    """The registered ``cruller_eval_ocr`` task on ``device`` in bf16, set
    up, with every row of its tied table but the byte tokens' zeroed: with
    random weights the prompt token's own row would win every greedy step,
    and the fillers and tags clean to empty text, leaving no CER/WER.
    ``env``: the task's environment (default: one process on ``device``)."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerEvalOCRCfg(
        model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
        device=device, kv_cache_dtype=mode, lm_head_dtype=mode,
    )
    task, _ = TaskFactory.create_task("cruller_eval_ocr", cfg, env or DeviceEnv.initialize(device))
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
                      profile=False, remat=False, phase="train_model"):
    """``remat``: the model's remat mode; ``phase``: the name the record
    and its failures carry (``large`` trains cruller_large through here)."""
    from pixparse_tpu_torch.framework.train_state import create_train_state, make_train_step
    from pixparse_tpu_torch.ops import loss as loss_ops

    model, optimizer, vit_cfg, bart_cfg = build_train_model(torch, model_name, device)
    model.remat = remat
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
        "phase": phase, "model": model_name, "batch": B, "dtype": "bfloat16", "remat": remat,
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

        tag = "train_step" if phase == "train_model" else f"{phase}_train_step"
        rec["profile"] = device_profile(torch, one_step, tag, ms_per_step)
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
        raise SystemExit(f"{phase} failed: " + "; ".join(problems))
    rec["launches"] = {k: sum(step[k] for step in per_step) for k in per_step[0]}
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
    if sum(donut_ln_sites(B, model_name).values()) != n_ln:  # the kernels phase's shapes
        problems.append(f"{n_ln} LayerNorms, the geometry counts {donut_ln_sites(B, model_name)}")
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


PRETRAINED_B = 16  # pretrained_train: batch and steps at cruller_base
PRETRAINED_STEPS = 2
# the published files it stands in for: vit_base_patch16_224 (3 channels,
# 14x14 patches + cls) and facebook/bart-base's decoder (6 layers, vocab
# 50265, 1026 positions)
PRETRAINED_FILES = dict(in_chans=3, grid=14, layers=6, vocab=BART_VOCAB, positions=1026)


def pretrained_files(torch, out_dir, enc_name, dec_name, in_chans, grid, layers, vocab, positions,
                     seed=0):
    """Seeded stand-ins for published backbones, written as ``.pt`` under
    their clean names: a timm-layout ViT (``in_chans`` channels, a ``grid``
    x ``grid`` patch grid + cls) and an HF-layout decoder (``model.decoder.*``
    and ``lm_head``; ``layers`` layers, ``vocab`` tokens, ``positions``
    rows). The port's own modules at those shapes carry exactly these names.
    Returns both state dicts (CPU, fp32)."""
    import dataclasses

    from pixparse_tpu_torch.models.bart import BartCausalDecoder, resolve_bart_cfg
    from pixparse_tpu_torch.models.pretrained import _clean_name
    from pixparse_tpu_torch.models.vit import VIT_ARCH_TABLE, ViT, resolve_vit_cfg

    gen = torch.Generator().manual_seed(seed)
    side = grid * VIT_ARCH_TABLE[enc_name.split(".")[0]]["patch_size"]
    vit = ViT(resolve_vit_cfg(enc_name, (side, side), in_chans)[0], "xla")
    vit.init_weights(gen)
    bart_cfg = resolve_bart_cfg(dec_name, num_decoder_layers=layers, vocab_size=vocab)
    bart_cfg = dataclasses.replace(bart_cfg, max_position_embeddings=positions - bart_cfg.pos_offset)
    bart = BartCausalDecoder(bart_cfg, "xla")
    bart.init_weights(gen)
    dicts = []
    for name, module in ((enc_name, vit), (dec_name, bart)):
        sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
        torch.save(sd, os.path.join(out_dir, _clean_name(name) + ".pt"))
        dicts.append(sd)
    return dicts


def phase_pretrained_train(torch, model_name="cruller_base", B=PRETRAINED_B, steps=PRETRAINED_STEPS,
                           files=PRETRAINED_FILES, device="cuda"):
    """``cruller_pretrain`` with both backbones from local files:
    ``$PIXPARSE_PRETRAINED_DIR`` holds :func:`pretrained_files`, and the
    tokenizer is the byte-level one padded to the file's vocabulary, to
    which the task adds its special tokens. ``train_setup`` with both
    ``pretrained`` flags adapts (at cruller_base) 3 -> 1 channels, 14x14 ->
    36x28 positions, 6 -> 4 decoder layers and 50265 -> the tokenizer's
    vocabulary; the loaded weights must equal the file tensors adapted here
    (``torch.equal``). Then ``steps`` steps of ``train_one_interval`` at
    batch B, each loss finite; counters zeroed before the steps, read after."""
    import re
    import shutil
    import tempfile

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.train import train_one_interval
    from pixparse_tpu_torch.models import interop
    from pixparse_tpu_torch.models.pretrained import _fit_rows, maybe_load_pretrained
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrainCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrained_")
    env_before = os.environ.get("PIXPARSE_PRETRAINED_DIR")
    try:
        tok_dir = saved_tokenizer(os.path.join(tmp, "tokenizer"), files["vocab"], specials=False)
        cfg = TaskCrullerPretrainCfg(
            model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
            device=device, num_intervals=1, num_warmup_intervals=0,
            opt=OptimizationCfg(learning_rate=3e-4),
        )
        cfg.model.image_encoder.pretrained = cfg.model.text_decoder.pretrained = True
        task, _ = TaskFactory.create_task("cruller_pretrain", cfg, DeviceEnv.initialize(device),
                                          monitor=None)
        vit_cfg, bart_cfg = task.vit_cfg, task.bart_cfg
        t0 = time.perf_counter()
        vit_sd, bart_sd = pretrained_files(torch, tmp, cfg.model.image_encoder.name,
                                           cfg.model.text_decoder.name, **files)
        write_s = time.perf_counter() - t0
        os.environ["PIXPARSE_PRETRAINED_DIR"] = tmp
        t0 = time.perf_counter()
        maybe_load_pretrained(cfg.model, vit_cfg, bart_cfg)
        resolve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        task.train_setup(num_batches_per_interval=steps, seed=0)
        sync(torch)
        setup_s = time.perf_counter() - t0
        # the file tensors adapted here, as the model should now hold them
        want = dict(vit_sd)
        want["patch_embed.proj.weight"] = interop.adapt_patch_weight(
            want["patch_embed.proj.weight"], vit_cfg.in_chans)
        want["pos_embed"] = interop.resize_pos_embed(want["pos_embed"], vit_cfg.grid_size)
        want = {interop.ENC_PREFIX + k: v for k, v in want.items()}
        dec = {}
        for k, v in bart_sd.items():
            layer = re.match(r"model\.decoder\.layers\.(\d+)\.", k)
            if k.startswith("model.decoder.") and (not layer or int(layer.group(1)) < bart_cfg.decoder_layers):
                dec[interop.DEC_PREFIX + k[len("model.decoder."):]] = v
        key = interop.DEC_PREFIX + "embed_positions.weight"
        dec[key] = _fit_rows(dec[key], bart_cfg.max_position_embeddings + bart_cfg.pos_offset)
        want.update(interop.resize_token_embeddings(dec, task.vocab_size))
        got = task.model.state_dict()
        mismatched = [k for k in want if not torch.equal(got[k].detach().cpu(), want[k])]
        not_from_files = sorted(set(got) - set(want) - {interop.LM_HEAD_KEY})
        loader = SeededLoader(torch, steps, B, vit_cfg.img_size, task.max_position_embeddings,
                              seed=11, in_chans=vit_cfg.in_chans, vocab=task.vocab_size)
        losses, _ = timed_steps(task, lambda: sync(torch))
        reset_counts()
        t0 = time.perf_counter()
        train_one_interval(task, loader)
        sync(torch)
        train_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        if env_before is None:
            os.environ.pop("PIXPARSE_PRETRAINED_DIR", None)
        else:
            os.environ["PIXPARSE_PRETRAINED_DIR"] = env_before
        shutil.rmtree(tmp, ignore_errors=True)
    ok = not mismatched and not not_from_files
    emit({"phase": "pretrained_train", "model": model_name, "batch": B, "steps": steps,
          "files": files, "adapted_to": {"in_chans": vit_cfg.in_chans, "grid": list(vit_cfg.grid_size),
                                         "decoder_layers": bart_cfg.decoder_layers,
                                         "vocab": task.vocab_size},
          "write_files_s": write_s, "resolve_and_load_s": resolve_s, "train_setup_s": setup_s,
          "loaded_equal_adapted_files": ok, "mismatched": mismatched[:8],
          "not_from_files": not_from_files[:8], "losses": losses, "train_s": train_s,
          "launches": launches, "launch_unit": "wrapper calls"})
    problems = []
    if not ok:
        problems.append(f"loaded tensors differ from the adapted files: {mismatched[:4]} {not_from_files[:4]}")
    if len(losses) != steps or not all(abs(x) < float("inf") for x in losses):
        problems.append(f"losses not finite: {losses}")
    if device == "cuda":
        absent = [k for k in PRETRAINED_KERNELS if launches[k] <= 0]
        if absent:
            problems.append(f"main path never launched {absent}")
    if problems:
        raise SystemExit("pretrained_train failed: " + "; ".join(problems))
    return {"pretrained_train": launches}


# --------------------------------------------------------------------------
# the finetune and eval tasks
# --------------------------------------------------------------------------

FINETUNE_BATCHES = 2
EVAL_BATCH = {"cord": 8, "docvqa": 8, "rvlcdip": 16}  # (b): one batch each
XENT_B, XENT_STEPS = 16, 3  # (c)
# what each run of finetune_tasks launches, exactly, from the encoder's
# depth d, the decoder's layers l, the run's steps (train) or batches (eval)
# n and its single-token decode steps s; every other count is 0
FINETUNE_TASK_KERNELS = {
    "finetune_cord": lambda d, l, n, s: dict(
        flash_attention_fwd=n * (d + 2 * l), flash_attention_bwd=n * (d + 2 * l),
        fused_ce_fwd=n, fused_ce_bwd=n),
    "eval_cord": lambda d, l, n, s: dict(flash_attention_fwd=n * d, decode_attention=2 * l * s),
    "eval_docvqa": lambda d, l, n, s: dict(flash_attention_fwd=n * d, decode_attention=2 * l * s),
    "eval_rvlcdip": lambda d, l, n, s: dict(flash_attention_fwd=n * d, decode_attention=2 * l * s),
    "finetune_xent": lambda d, l, n, s: dict(flash_attention_fwd=n * d, flash_attention_bwd=n * d),
}
STEP1_LOSS_RTOL = 1e-3  # finetune_tasks (a): task.loss_fn, kernel path vs plain path
STEP1_GRAD_RTOL = 5e-2  # each parameter's gradient, in L2
STEP1_GRAD_FLOOR = 1e-2  # of the median leaf norm: leaves whose true gradient is 0
CORD_FIELDS = ("nm", "cnt", "unitprice", "price")


def uint8_pages(n, H, W, rng):
    """Page-like uint8 (H, W) arrays, as an image dataset holds them: light
    background with dark text-line bands."""
    import numpy as np

    pages = []
    for _ in range(n):
        page = np.full((H, W), 235, np.uint8)
        for y in range(8, H - 16, 24):
            w = int(rng.randint(W // 4, W - 16))
            page[y:y + 12, 8:8 + w] = rng.randint(0, 100, (12, w))
        pages.append(page)
    return pages


def cord_items(n, H, W, rng):
    """CORD-shaped items: ``ground_truth`` a JSON string of a nested
    ``gt_parse`` (menu rows, sub total, total)."""
    def money():
        return f"{rng.randint(1, 999)}.{rng.randint(0, 99):02d}"

    items = []
    for page in uint8_pages(n, H, W, rng):
        menu = [{k: (f"item {rng.randint(1000)} " * 2).strip() if k == "nm" else money()
                 for k in CORD_FIELDS[:2 + rng.randint(3)]} for _ in range(1 + rng.randint(12))]
        gt = {"gt_parse": {"menu": menu,
                           "sub_total": {"subtotal_price": money(), "tax_price": money()},
                           "total": {"total_price": money(), "cashprice": money(),
                                     "changeprice": money()}}}
        items.append({"image": page, "ground_truth": json.dumps(gt)})
    return items


def docvqa_items(n, H, W, rng):
    """DocVQA eval-shaped items: several questions of different lengths."""
    words = "what is the total amount date name of company on this page form".split()
    return [{"image": page, "question_id": i, "labels": {
        "question": " ".join(rng.choice(words, 2 + 3 * (i % 4))) + "?",
        "answers": [f"answer {i}", str(rng.randint(100))]}}
        for i, page in enumerate(uint8_pages(n, H, W, rng))]


def rvlcdip_items(n, H, W, rng):
    return [{"image": page, "label": i % 16} for i, page in enumerate(uint8_pages(n, H, W, rng))]


def hf_bundle(items, B, collate_fn, is_train, seed=0):
    from pixparse_tpu_torch.data.loader import HfDatasetLoader
    from pixparse_tpu_torch.data.wds import LoaderBundle

    loader = HfDatasetLoader(items, B, collate_fn, is_train=is_train, seed=seed, num_workers=2)
    return LoaderBundle(loader=loader, num_batches=len(loader), num_samples=len(items))


def timed_steps(task, sync_fn):
    """Wraps ``task.train_step``: each step's loss (read, so the step has
    ended) and wall ms land in the returned lists."""
    losses, times = [], []
    step = task.train_step

    def recorded(sample):
        t0 = time.perf_counter()
        out = step(sample)
        losses.append(float(out["loss"]))
        sync_fn()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    task.train_step = recorded
    return losses, times


def first_decode_vs_plain(torch, task, images, prompts):
    """The first decode step of ``generate``'s path on ragged prompts
    (right-padded, left-aligned: pad keys at the front of the self cache):
    prefill, argmax, one single-token decode (the decode kernel on the card),
    against one teacher-forced pass of plain attention over the same tokens,
    positions and key mask."""
    from pixparse_tpu_torch.models.bart import KVCache
    from pixparse_tpu_torch.ops.generation import _left_align_prompts

    model, pad = task.model, task.tokenizer.pad_token_id
    with torch.inference_mode():
        enc = task.encode_images(images)
        prompts = torch.as_tensor(prompts, device=enc.device).long()
        aligned, positions, valid = _left_align_prompts(prompts, pad)
        B, Lp = aligned.shape
        buffer = torch.full((B, Lp + 1), pad, dtype=torch.long, device=enc.device)
        buffer[:, :Lp] = aligned
        cache = KVCache(max_len=Lp + 1)
        first = model.decode(aligned, enc, cache, key_pad_mask=buffer != pad, mode="prefill",
                             positions=positions)[:, -1].argmax(-1)
        buffer[:, Lp] = first
        step = model.decode(first[:, None], enc, cache, key_pad_mask=buffer != pad,
                            mode="decode", positions=valid[:, None])[:, -1]
        impl = model.attn_impl
        model.attn_impl = "xla"
        try:
            parallel = model.decode(
                buffer, enc, attention_mask=buffer != pad, mode="train",
                positions=torch.cat([positions, valid[:, None]], dim=1))[:, -1]
        finally:
            model.attn_impl = impl
    err, ok = close(step, parallel, 5e-2, 5e-2)
    return {"prompt_lengths": valid.tolist(), "max_abs_err": err, "tol": [5e-2, 5e-2], "ok": ok}


def step1_kernel_vs_plain(torch, task, batch, kernel_impl):
    """The train task's own loss (``task.loss_fn``) and the gradient of every
    parameter on ``batch``, dropout off, on the kernel path (``kernel_impl``
    attention, the fused CE) and on the plain path (plain attention, the
    chunked plain CE in the task's place): the loss within
    STEP1_LOSS_RTOL, each leaf's gradient within STEP1_GRAD_RTOL in L2 of the
    plain one (or of STEP1_GRAD_FLOOR of the median leaf norm, for leaves
    whose true gradient is 0, as the key biases' is)."""
    import pixparse_tpu_torch.task.cruller_base as base
    from pixparse_tpu_torch.ops import loss as loss_ops

    model = task.model
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    fused, plain_ce = base.cross_entropy_from_hidden, loss_ops.chunked_cross_entropy_from_hidden
    losses, grads = {}, {}
    model.eval()
    try:
        for path, impl, ce in (("kernel", kernel_impl, fused), ("plain", "xla", plain_ce)):
            model.attn_impl, base.cross_entropy_from_hidden = impl, ce
            loss, _ = task.loss_fn(batch)
            got = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
            losses[path] = float(loss.detach())
            grads[path] = [torch.zeros_like(p) if g is None else g.float()
                           for (_, p), g in zip(named, got)]
            del loss, got
    finally:
        model.attn_impl, base.cross_entropy_from_hidden = kernel_impl, fused
        model.train()
    norms = [float(g.norm()) for g in grads["plain"]]
    floor = STEP1_GRAD_FLOOR * statistics.median(norms)
    rel = {n: float((a - b).norm()) / max(ref, floor) for (n, _), a, b, ref in
           zip(named, grads["kernel"], grads["plain"], norms)}
    worst = sorted(rel, key=rel.get, reverse=True)[:5]
    global_norms = {path: math.sqrt(sum(float(g.square().sum()) for g in gs))
                    for path, gs in grads.items()}
    loss_ok = abs(losses["kernel"] - losses["plain"]) <= STEP1_LOSS_RTOL * abs(losses["plain"])
    return {"loss": losses, "grad_norm": global_norms, "leaves": len(named),
            "worst_leaf_rel_err": {n: rel[n] for n in worst}, "grad_floor": floor,
            "tol": {"loss_rel": STEP1_LOSS_RTOL, "grad_leaf_rel": STEP1_GRAD_RTOL,
                    "grad_floor_of_median": STEP1_GRAD_FLOOR},
            "ok": loss_ok and rel[worst[0]] <= STEP1_GRAD_RTOL}


def counted_decode_steps(model):
    """Wraps ``model.decode``: the returned list's one entry counts its
    single-token decode steps (each launches the decode kernel once a
    decoder layer for self- and once for cross-attention)."""
    steps = [0]
    decode = model.decode

    def counted(ids, *args, mode="train", **kw):
        steps[0] += mode == "decode" and ids.shape[1] == 1
        return decode(ids, *args, mode=mode, **kw)

    model.decode = counted
    return steps


def phase_finetune_tasks(torch, model_name="cruller_base", B=FINETUNE_B,
                         n_batches=FINETUNE_BATCHES, eval_batch=EVAL_BATCH, xent=(XENT_B, XENT_STEPS),
                         tok_vocab=BART_VOCAB, lr=3e-4, device="cuda"):
    """The finetune and eval tasks through their entry points, over
    in-process indexable datasets of seeded uint8 pages fed through
    ``HfDatasetLoader`` and each task's ``collate_fn`` (the card machine has
    neither PIL nor ``datasets``); the tokenizer is the byte-level one padded
    to ``tok_vocab`` entries, to which each task adds its own tokens.

    (a) ``cruller_finetune_cord`` from a seeded pretrain ``state_dict``
    (vocabulary ``tok_vocab`` + 2, grown by the CORD replay), two intervals
    of ``n_batches`` batches of ``B``: losses finite and the second
    interval's mean below the first's; the step-1 loss of the kernel path
    (flash + fused CE) and every parameter's gradient against the plain
    path's (plain attention, chunked plain CE) on the first batch
    (``step1_kernel_vs_plain``). (b)
    ``cruller_eval_{cord,docvqa,rvlcdip}`` in bf16 from (a)'s weights, one
    batch each through ``framework.eval.evaluate``: every metric finite; the
    first DocVQA decode step's logits on its ragged prompts within 5e-2 of
    the plain path's. (c) ``cruller_finetune_xent`` with (a)'s encoder,
    ``xent[1]`` steps of ``xent[0]``. Counters zeroed before and read after
    each run; each run must launch exactly what FINETUNE_TASK_KERNELS
    works out from its geometry, and nothing else."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.eval import evaluate
    from pixparse_tpu_torch.framework.train import train_one_interval
    from pixparse_tpu_torch.models.cruller import Cruller
    from pixparse_tpu_torch.models.interop import cruller_state_dict
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    env = DeviceEnv.initialize(device)
    rng = np.random.RandomState(0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    runs, launches, problems = {}, {}, []

    def make(name, **kw):
        cfg = TASK_CLASS_REGISTRY[name][1](
            model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), device=device, **kw)
        return TaskFactory.create_task(name, cfg, env)[0]

    def check_launches(tag, vit, bart, n, decode_steps=0):
        """On the card, ``tag``'s counts must be FINETUNE_TASK_KERNELS'; on
        the CPU every count is 0."""
        want = {k: 0 for k in counters()}
        if device == "cuda":
            want.update(FINETUNE_TASK_KERNELS[tag](vit.depth, bart.decoder_layers, n, decode_steps))
        if launches[tag] != want:
            problems.append(f"{tag}: launched {launches[tag]}, want {want}")

    try:
        tok_dir = saved_tokenizer(os.path.join(tmp, "tokenizer"), tok_vocab, specials=False)
        # (a) CORD finetune from a seeded pretrain checkpoint
        train_kw = dict(dtype="bfloat16", num_intervals=2, num_warmup_intervals=0,
                        opt=OptimizationCfg(learning_rate=lr))
        task = make("cruller_finetune_cord", **train_kw)
        pre_vocab = task.vocab_size_base
        t0 = time.perf_counter()
        pre = Cruller(task.vit_cfg, dataclasses.replace(task.bart_cfg, vocab_size=pre_vocab))
        task.resume_state_dict = cruller_state_dict(pre.init_weights(torch.Generator().manual_seed(0)))
        del pre
        H, W = task.vit_cfg.img_size
        bundle = hf_bundle(cord_items(B * n_batches, H, W, rng), B, task.collate_fn, True)
        task.train_setup(num_batches_per_interval=bundle.num_batches, seed=0)
        setup_s = time.perf_counter() - t0
        first = task._to_device(task.normalize_batch(task.collate_fn(
            [bundle.loader.dataset[i] for i in bundle.loader.batch_indices()[0]])))
        step1 = step1_kernel_vs_plain(torch, task, first, "flash" if device == "cuda" else "xla")
        losses, times = timed_steps(task, lambda: sync(torch))
        reset_counts()
        t0 = time.perf_counter()
        for interval in range(2):
            bundle.set_interval(interval)
            task.interval_idx = interval
            train_one_interval(task, bundle)
        sync(torch)
        wall = time.perf_counter() - t0
        launches["finetune_cord"] = read_counts()
        ms = statistics.median(times[1:]) if len(times) > 1 else times[0]
        halves = [float(np.mean(losses[:n_batches])), float(np.mean(losses[n_batches:]))]
        runs["finetune_cord"] = {
            "vocab": [pre_vocab, task.vocab_size], "batch": B, "text_len": int(first["text"].shape[1]),
            "steps": len(losses), "losses": losses, "interval_mean_losses": halves,
            "step_ms": times, "ms_per_step": ms, "samples_per_s": B / (ms / 1e3),
            "wall_samples_per_s": len(losses) * B / wall, "setup_s": setup_s,
            "step1_kernel_vs_plain": step1, "launches": launches["finetune_cord"]}
        if not (len(losses) == 2 * n_batches and all(np.isfinite(losses)) and halves[1] < halves[0]):
            problems.append(f"finetune_cord: losses not finite and falling: {losses}")
        if tok_vocab == BART_VOCAB and task.vocab_size != CORD_FINETUNE_VOCAB:
            problems.append(f"finetune_cord: vocabulary {task.vocab_size}, the kernels phase "
                            f"holds the fused CE at {CORD_FINETUNE_VOCAB}")
        if not step1["ok"]:
            problems.append(f"finetune_cord: step 1, kernel path vs plain path: {step1}")
        check_launches("finetune_cord", task.vit_cfg, task.bart_cfg, len(losses))
        weights = task.state_dict()
        del task, first
        if device == "cuda":
            torch.cuda.empty_cache()

        # (b) the three eval tasks in bf16 from (a)'s weights
        makers = {"cord": cord_items, "docvqa": docvqa_items, "rvlcdip": rvlcdip_items}
        for short, n in eval_batch.items():
            tag = f"eval_{short}"
            task = make(f"cruller_eval_{short}", dtype="bfloat16")
            task.resume_state_dict = weights
            task.setup()
            items = makers[short](n, H, W, rng)
            bundle = hf_bundle(items, n, task.collate_fn, False)
            decode_steps = counted_decode_steps(task.model)
            reset_counts()
            sync(torch)
            t0 = time.perf_counter()
            metrics = evaluate(task, {"eval": bundle})
            sync(torch)
            dt = time.perf_counter() - t0
            launches[tag], steps = read_counts(), decode_steps[0]
            avg = metrics["eval"]["average"]
            flat = avg["classification"] if short == "rvlcdip" else avg
            runs[tag] = {"vocab": task.vocab_size, "batch": n, "seconds": dt,
                         "pages_per_s": n / dt, "max_generation_length": task.max_generation_length,
                         "decode_steps": steps, "metrics": avg, "launches": launches[tag]}
            if not flat or not all(np.isfinite(v) for v in flat.values()):
                problems.append(f"{tag}: metrics missing or not finite: {avg}")
            if short == "docvqa":
                batch = task.collate_fn(items)
                dec = first_decode_vs_plain(torch, task, batch["images"],
                                            task.batch_prompts(batch["questions"]))
                runs[tag]["first_decode_vs_plain"] = dec
                if not dec["ok"] or len(set(dec["prompt_lengths"])) < 2:
                    problems.append(f"{tag}: first decode step vs plain path: {dec}")
            check_launches(tag, task.vit_cfg, task.bart_cfg, bundle.num_batches, steps)
            del task
            if device == "cuda":
                torch.cuda.empty_cache()

        # (c) the classifier with (a)'s encoder
        xb, xsteps = xent
        task = make("cruller_finetune_xent", **dict(train_kw, num_intervals=1))
        task.resume_state_dict = weights
        bundle = hf_bundle(rvlcdip_items(xb * xsteps, H, W, rng), xb, task.collate_fn, True)
        task.train_setup(num_batches_per_interval=bundle.num_batches, seed=0)
        losses, times = timed_steps(task, lambda: sync(torch))
        reset_counts()
        t0 = time.perf_counter()
        train_one_interval(task, bundle)
        sync(torch)
        wall = time.perf_counter() - t0
        launches["finetune_xent"] = read_counts()
        ms = statistics.median(times[1:]) if len(times) > 1 else times[0]
        runs["finetune_xent"] = {
            "batch": xb, "steps": len(losses), "losses": losses, "step_ms": times,
            "ms_per_step": ms, "samples_per_s": xb / (ms / 1e3),
            "wall_samples_per_s": len(losses) * xb / wall, "state_dict_keys": sorted(
                {k.split(".")[0] for k in task.state_dict()}), "launches": launches["finetune_xent"]}
        if len(losses) != xsteps or not all(np.isfinite(losses)):
            problems.append(f"finetune_xent: losses not finite: {losses}")
        check_launches("finetune_xent", task.vit_cfg, task.bart_cfg, len(losses))
        del task
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "finetune_tasks", "model": model_name, "dtype": "bfloat16",
          "tokenizer": f"pixparse_bytelevel + filler tokens to {tok_vocab}, from a saved directory",
          "runs": runs, "launch_unit": "wrapper calls"})
    if problems:
        raise SystemExit("finetune_tasks failed: " + "; ".join(problems))
    return {f"finetune_tasks_{tag}": n for tag, n in launches.items()}


# --------------------------------------------------------------------------
# beam search, sampling, the naive oracle, cruller_large
# --------------------------------------------------------------------------

BEAM_RUNS = (  # tag, model, vocabulary, batch, new tokens, decode mode
    ("cruller_base", "cruller_base", BART_VOCAB, 16, MODEL_NEW_TOKENS, "bf16"),
    ("cruller_base_int8", "cruller_base", BART_VOCAB, 16, MODEL_NEW_TOKENS, "int8"),
    ("donut_base", "donut_base", DONUT_VOCAB, 8, DONUT_NEW_TOKENS, "bf16"),
)
BEAM_SCORE_ATOL = 1e-2  # beam's summed log-prob >= greedy's less this (bf16 scoring pass)
SAMPLE_T = 5.0  # generate()'s default temperature, as JAX's
SAMPLE_DRAWS = 4096
SAMPLE_BINS = 64  # chi-square bins of equal expected count (64 draws each)
SAMPLE_P_MIN = 1e-3
BF16_TIE = 0.0625  # naive: a top-2 logit margin under this is a bf16 tie


class NoEos:
    """A tokenizer as it is but for ``eos_token_id`` -1: every page decodes
    the whole budget (EOS off, as in ``serve_model``), so the step count
    and the time per step are fixed by construction."""

    eos_token_id = -1

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer

    def __getattr__(self, name):
        return getattr(self._tokenizer, name)


def seeded_model(torch, model_name, device, vocab=BART_VOCAB, **kw):
    """(model, encoder cfg, decoder cfg): the registered model from seed-0
    weights, bf16 on ``device``, the kernels' attention."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import Cruller, resolve_cruller_cfgs

    enc_cfg, bart_cfg, _ = resolve_cruller_cfgs(get_model_config(model_name), vocab_size=vocab)
    model = Cruller(enc_cfg, bart_cfg, attn_impl="flash", **kw)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device, torch.bfloat16).eval(), enc_cfg, bart_cfg


def copy_cache(cache):
    import dataclasses

    lists = ("self_k", "self_v", "cross_k", "cross_v", "cross_k_scale", "cross_v_scale")
    return dataclasses.replace(
        cache, qkv=list(cache.qkv), **{f: [t.clone() for t in getattr(cache, f)] for f in lists},
        cross_mask=None if cache.cross_mask is None else cache.cross_mask.clone())


def reordered_step_vs_plain(torch, model, enc, prompt, K, pad, step=2):
    """``generate_beam``'s decode step ``step`` (its caches reordered by the
    beams' sources ``step`` times; the first reorder only copies beam 0)
    through the decode kernels, against the same step with the plain decode
    attention on a copy of those caches."""
    import contextlib

    from pixparse_tpu_torch.models import bart
    from pixparse_tpu_torch.ops import decode_attention as da
    from pixparse_tpu_torch.ops.generation import generate_beam

    seen, sources = {}, []
    decode, reorder = model.decode, bart.KVCache.reorder

    def spy(ids, enc_, cache=None, *args, mode="decode", **kw):
        if mode == "decode":
            seen["n"] = seen.get("n", 0) + 1
            if seen["n"] == step:
                seen.update(cache=copy_cache(cache), ids=ids.clone(), kw=kw)
                out = decode(ids, enc_, cache, *args, mode=mode, **kw)
                seen["out"] = out.clone()
                return out
        return decode(ids, enc_, cache, *args, mode=mode, **kw)

    def spy_reorder(cache, src):
        sources.append(src.clone())
        return reorder(cache, src)

    @contextlib.contextmanager
    def patched(obj, **attrs):
        saved = {k: getattr(obj, k) for k in attrs}
        for k, v in attrs.items():
            setattr(obj, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(obj, k, v)

    with torch.inference_mode():
        with patched(model, decode=spy), patched(bart.KVCache, reorder=spy_reorder):
            generate_beam(model, enc, prompt, num_beams=K, max_length=prompt.shape[1] + step + 1,
                          eos_token_id=-1, pad_token_id=pad)
        with patched(bart, decode_attention=da.decode_attention_plain,
                     decode_attention_q8=da.decode_attention_q8_plain):
            plain = decode(seen["ids"], enc, seen["cache"], mode="decode", **seen["kw"])
    err, ok = close(seen["out"], plain, 5e-2, 5e-2)
    src = sources[step - 1]
    moved = int((src != torch.arange(len(src), device=src.device)).sum())
    return {"step": step, "rows_from_another_beam": moved, "max_abs_err": err,
            "tol": [5e-2, 5e-2], "ok": ok}


def sequence_logprobs(torch, model, enc, tokens, pad):
    """Each row's summed log-prob of its tokens after the first, by one
    teacher-forced pass (pad positions masked and not counted)."""
    with torch.inference_mode():
        mask = tokens != pad
        logits = model.decode(tokens, enc, mode="train",
                              attention_mask=None if bool(mask.all()) else mask)
        lp = torch.log_softmax(logits.float(), dim=-1)[:, :-1]
        tok = lp.gather(-1, tokens[:, 1:, None])[..., 0]
        return (tok * mask[:, 1:]).sum(dim=1)


def phase_beam_eval(torch, runs=BEAM_RUNS, K=BEAM_K, device="cuda", profile=False):
    """Beam search through the eval entry point,
    ``TaskCrullerEvalOCR.generate_ids`` with ``num_beams = K``, at full
    width from seed-0 weights in bf16, EOS off, beside greedy
    (``num_beams = 1``) at the same batch; each run's counters zeroed
    before and read after the beam call. Gates: ``num_beams=1`` of
    ``generate_beam`` equals ``generate``'s tokens; at ``length_penalty=0``
    the best beam's summed log-prob (one teacher-forced pass) is at least
    the greedy sequence's less BEAM_SCORE_ATOL; a decode step on reordered
    caches matches the plain decode attention within 5e-2; exact launch
    counts. Also the reorder's device time per step at the mean prefix."""
    import shutil
    import tempfile

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.models.bart import KVCache
    from pixparse_tpu_torch.models.swin import SwinCfg
    from pixparse_tpu_torch.ops.generation import generate, generate_beam
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    on_card = torch.cuda.is_available()
    rec = {"phase": "beam_eval", "task": "cruller_eval_ocr", "dtype": "bfloat16", "beams": K,
           "eos": "off", "launch_unit": "wrapper calls", "runs": {}}
    path_launches, problems = {}, []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_beam_")
    try:
        for tag, model_name, vocab, B, new_tokens, mode in runs:
            tok_dir = saved_tokenizer(os.path.join(tmp, f"tok{vocab}"), vocab)
            cfg = TaskCrullerEvalOCRCfg(
                model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
                device=device, kv_cache_dtype=mode, lm_head_dtype=mode)
            task, _ = TaskFactory.create_task("cruller_eval_ocr", cfg, DeviceEnv.initialize(device))
            task.setup()  # seed-0 weights
            task.tokenizer = NoEos(task.tokenizer)
            model, enc_cfg, bart_cfg = task.model, task.vit_cfg, task.bart_cfg
            pad = task.tokenizer.pad_token_id
            gen = torch.Generator().manual_seed(2)
            images = synthetic_pages(torch, B, *enc_cfg.img_size, gen)
            images = images.expand(-1, -1, -1, enc_cfg.in_chans).contiguous()
            prompt = task.prompt_ids(task.task_start_token, B)
            Lp = prompt.shape[1]
            max_length = Lp + new_tokens
            steps = new_tokens - 1  # the last token's decode step is skipped

            def timed(fn):
                sync(torch)
                t0 = time.perf_counter()
                out = fn()
                sync(torch)
                return out, time.perf_counter() - t0

            task.num_beams = K
            task.generate_ids(images[:2], prompt[:2], max_length=Lp + 3)  # warm-up
            _, encode_s = timed(lambda: task.encode_images(images))
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            beam_ids, beam_s = timed(lambda: task.generate_ids(images, prompt, max_length))
            launches = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
            path_launches[f"beam_eval_{tag}"] = launches
            task.num_beams = 1
            greedy_ids, greedy_s = timed(lambda: task.generate_ids(images, prompt, max_length))
            run = {
                "model_name": model_name, "decode_mode": mode, "vocab": vocab, "batch": B,
                "rows": B * K, "new_tokens": new_tokens, "decode_steps": steps,
                "encode_ms": encode_s * 1e3,
                "beam": {"seconds": beam_s, "pages_per_s": B / beam_s,
                         "decode_ms_per_step": (beam_s - encode_s) * 1e3 / steps,
                         "peak_memory_gib": peak_gb},
                "greedy": {"seconds": greedy_s, "pages_per_s": B / greedy_s,
                           "decode_ms_per_step": (greedy_s - encode_s) * 1e3 / steps},
                "launches": launches,
            }
            run["beam_over_greedy_decode_step"] = (
                run["beam"]["decode_ms_per_step"] / run["greedy"]["decode_ms_per_step"])
            kw = dict(max_length=max_length, eos_token_id=-1, pad_token_id=pad)
            enc = task.encode_images(images)
            p = torch.as_tensor(prompt, device=enc.device)
            if mode == "bf16":  # one beam is greedy (the int8 mode's greedy uses the int8 head)
                one = generate_beam(model, enc, p, num_beams=1, **kw)
                run["one_beam_equals_greedy"] = bool(torch.equal(
                    one.tokens.cpu(), torch.as_tensor(greedy_ids)))
                if not run["one_beam_equals_greedy"]:
                    problems.append(f"{tag}: num_beams=1 tokens differ from greedy")
            lp0 = generate_beam(model, enc, p, num_beams=K, length_penalty=0.0, **kw)
            g = generate(model, enc, p, **kw)
            both = sequence_logprobs(torch, model, torch.cat([enc, enc]),
                                     torch.cat([lp0.tokens, g.tokens]), pad)
            margin = (both[:B] - both[B:]).cpu()
            run["score_dominance"] = {
                "beam_minus_greedy_min": float(margin.min()),
                "beam_minus_greedy_mean": float(margin.mean()), "atol": BEAM_SCORE_ATOL,
                "beam_equals_greedy_rows": int((lp0.tokens == g.tokens).all(dim=1).sum())}
            if float(margin.min()) < -BEAM_SCORE_ATOL:
                problems.append(f"{tag}: best beam's log-prob below greedy's by {-float(margin.min())}")
            run["reordered_step_vs_plain"] = reordered_step_vs_plain(torch, model, enc, p, K, pad)
            if not run["reordered_step_vs_plain"]["ok"]:
                problems.append(f"{tag}: reordered decode step vs plain {run['reordered_step_vs_plain']}")
            # the reorder alone: every layer's self caches at B * K rows,
            # gathered at the mean prefix length of the run
            D, L = bart_cfg.d_model, bart_cfg.decoder_layers
            cache = KVCache(max_len=max_length, index=Lp + new_tokens // 2)
            len_pad = -(-max_length // 128) * 128
            for buf in (cache.self_k, cache.self_v):
                buf.extend(torch.randn(B * K, len_pad, D, device=enc.device, dtype=enc.dtype)
                           for _ in range(L))
            src = (torch.arange(B, device=enc.device)[:, None] * K
                   + torch.randint(0, K, (B, K), device=enc.device)).reshape(-1)
            if on_card:
                reorder_ms = Timer(torch).median_ms(lambda: cache.reorder(src), busy=True)
                run["reorder"] = {
                    "device_ms_per_step": reorder_ms, "prefix": cache.index,
                    "bytes": 2 * 2 * L * B * K * cache.index * D * enc.element_size(),
                    "share_of_beam_decode_step": reorder_ms / run["beam"]["decode_ms_per_step"]}
            del cache
            if profile:
                run["profile"] = device_profile(
                    torch, lambda: generate_beam(model, enc, p, num_beams=K, **kw),
                    f"beam_{tag}", (beam_s - encode_s) * 1e3)
            # exact counts (on the card): the encode, then two decode
            # launches a layer a step
            if isinstance(enc_cfg, SwinCfg):
                want = dict(window_attention=enc_cfg.depth)
            else:
                want = dict(flash_attention_fwd=enc_cfg.depth)
            if mode == "int8":
                want.update(decode_attention=steps * L, decode_attention_q8=steps * L)
            else:
                want.update(decode_attention=2 * steps * L)
            want = dict({k: 0 for k in counters()}, **want) if on_card else read_counts()
            if launches != want:
                problems.append(f"{tag}: launched {launches}, want {want}")
            if beam_ids.shape != (B, max_length) or (beam_ids == pad).any():
                problems.append(f"{tag}: beam tokens {beam_ids.shape}, pad in them")
            rec["runs"][tag] = run
            del task, model, enc, lp0, g
            if on_card:
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(rec)
    if problems:
        raise SystemExit("beam_eval failed: " + "; ".join(problems))
    return path_launches


def chi2_pvalue(draws, probs, bins=SAMPLE_BINS):
    """Pearson's chi-square of integer ``draws`` against ``probs`` (fp64),
    categories sorted by probability and cut into ``bins`` bins of equal
    expected count (a 50k-entry vocabulary has under one expected draw per
    entry)."""
    import numpy as np
    from scipy import stats

    order = np.argsort(probs)
    edges = np.searchsorted(np.cumsum(probs[order]), np.arange(1, bins) / bins)
    bin_of = np.empty(len(probs), np.int64)
    bin_of[order] = np.searchsorted(edges, np.arange(len(probs)), side="right")
    expected = np.bincount(bin_of, weights=probs, minlength=bins) * len(draws)
    observed = np.bincount(bin_of[draws], minlength=bins)
    keep = expected > 0
    return float(stats.chisquare(observed[keep], expected[keep] * observed.sum()
                                 / expected[keep].sum()).pvalue)


def phase_sample(torch, model_name="cruller_base", B=16, new_tokens=TASK_NEW_TOKENS,
                 draws=SAMPLE_DRAWS, device="cuda"):
    """``generate(sample=True)`` at full width, EOS off: the same generator
    seed gives the same tokens, another seed others; one step's draws for
    ``draws`` repeats of one row pass a chi-square test against
    ``softmax(logits / 5.0)`` computed in fp64 on the host."""
    import numpy as np

    from pixparse_tpu_torch.models.bart import KVCache
    from pixparse_tpu_torch.ops.generation import generate, select_next

    model, vit_cfg, bart_cfg = seeded_model(torch, model_name, device)
    images = synthetic_pages(torch, B, *vit_cfg.img_size, torch.Generator().manual_seed(3))
    prompt = torch.zeros(B, 1, dtype=torch.long, device=device)
    kw = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1)
    with torch.inference_mode():
        enc = model.encode(images.to(device))
        seeded = lambda seed: generate(
            model, enc, prompt, sample=True, temperature=SAMPLE_T,
            generator=torch.Generator(device=device).manual_seed(seed), **kw)
        seeded(0)  # warm-up
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        a = seeded(5)
        sync(torch)
        dt = time.perf_counter() - t0
        launches = read_counts()
        b, c = seeded(5), seeded(6)
        greedy = generate(model, enc, prompt, **kw)
        logits = model.decode(prompt[:1], enc[:1], KVCache(max_len=2), mode="prefill")[:, -1]
        rows = logits.float().expand(draws, -1)
        drawn = select_next(rows, True, SAMPLE_T,
                            torch.Generator(device=device).manual_seed(0)).cpu().numpy()
    x = logits[0].double().cpu().numpy()
    softmax = lambda z: np.exp(z - z.max()) / np.exp(z - z.max()).sum()
    p_t = chi2_pvalue(drawn, softmax(x / SAMPLE_T))
    p_1 = chi2_pvalue(drawn, softmax(x))
    steps = a.steps
    rec = {
        "phase": "sample", "model": model_name, "batch": B, "dtype": "bfloat16",
        "temperature": SAMPLE_T, "new_tokens": new_tokens, "decode_steps": steps,
        "seconds": dt, "decode_ms_per_step": dt * 1e3 / max(steps, 1),
        "same_seed_same_tokens": bool(torch.equal(a.tokens, b.tokens)),
        "other_seed_differs": not torch.equal(a.tokens, c.tokens),
        "differs_from_greedy": not torch.equal(a.tokens, greedy.tokens),
        "distinct_tokens": len(set(a.tokens[:, 1:].flatten().tolist())),
        "chi2": {"draws": draws, "bins": SAMPLE_BINS, "p_value": p_t, "p_min": SAMPLE_P_MIN,
                 "p_value_against_temperature_1": p_1,
                 "distinct_draws": int(len(np.unique(drawn)))},
        "launches": launches,
    }
    emit(rec)
    problems = []
    if not rec["same_seed_same_tokens"] or not rec["other_seed_differs"]:
        problems.append("the same seed must give the same tokens and another seed others")
    if not p_t > SAMPLE_P_MIN:
        problems.append(f"one-step draws against softmax(logits / {SAMPLE_T}): p = {p_t}")
    want = dict({k: 0 for k in counters()}, decode_attention=2 * bart_cfg.decoder_layers * steps)
    if (torch.cuda.is_available() and launches != want) or steps != new_tokens - 1:
        problems.append(f"launched {launches} over {steps} steps, want {want}")
    if problems:
        raise SystemExit("sample failed: " + "; ".join(problems))
    return {"sample": launches}


def phase_naive(torch, model_name="cruller_base", B=4, new_tokens=32, device="cuda"):
    """KV-cached ``generate`` against ``generate_naive`` (a cache-free
    full-prefix pass per token, through the flash kernels): the tokens
    agree up to the first disagreement, where the naive path's top-2 logit
    margin must be under BF16_TIE (a bf16 near-tie)."""
    from pixparse_tpu_torch.ops.generation import generate, generate_naive

    model, vit_cfg, bart_cfg = seeded_model(torch, model_name, device)
    images = synthetic_pages(torch, B, *vit_cfg.img_size, torch.Generator().manual_seed(4))
    prompt = torch.zeros(B, 1, dtype=torch.long, device=device)
    kw = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1)
    with torch.inference_mode():
        enc = model.encode(images.to(device))
        cached = generate(model, enc, prompt, **kw).tokens
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        naive = generate_naive(model, enc, prompt, **kw)
        sync(torch)
        dt = time.perf_counter() - t0
        launches = read_counts()
        rows = []
        for r in range(B):
            diff = (cached[r] != naive[r]).nonzero()
            if not len(diff):
                continue
            t = int(diff[0])
            logits = model.decode(naive[r:r + 1, :t], enc[r:r + 1], mode="train")[0, -1].float()
            top = logits.topk(2).values
            rows.append({"row": r, "first_disagreement": t, "top2_margin": float(top[0] - top[1]),
                         "cached": int(cached[r, t]), "naive": int(naive[r, t])})
    passes = new_tokens
    rec = {
        "phase": "naive", "model": model_name, "batch": B, "dtype": "bfloat16",
        "new_tokens": new_tokens, "passes": passes, "seconds": dt,
        "equal_rows": B - len(rows), "disagreements": rows, "tie_margin": BF16_TIE,
        "launches": launches,
    }
    emit(rec)
    problems = [f"row {d['row']}: tokens differ at {d['first_disagreement']} with a top-2 margin "
                f"of {d['top2_margin']}" for d in rows if not d["top2_margin"] < BF16_TIE]
    want = dict({k: 0 for k in counters()},
                flash_attention_fwd=passes * 2 * bart_cfg.decoder_layers)
    if torch.cuda.is_available() and launches != want:
        problems.append(f"launched {launches}, want {want}")
    if problems:
        raise SystemExit("naive failed: " + "; ".join(problems))
    return {"naive": launches}


def phase_large(torch, model_name="cruller_large", B=LARGE_B, new_tokens=TASK_NEW_TOKENS,
                steps=DONUT_TRAIN_STEPS, device="cuda", profile=False):
    """cruller_large at full width and depth: serve (``serve_model``'s run
    and gates, always with the profile for the idle share; its 24 bf16
    encoder layers held to the plain ones token by token) and train
    (``train_model``'s run and gates, under the auto remat mode)."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs
    from pixparse_tpu_torch.task.cruller_base import BaseCrullerTrainTask

    vit_cfg, _, _ = resolve_cruller_cfgs(get_model_config(model_name))
    remat = BaseCrullerTrainTask.auto_remat(types.SimpleNamespace(vit_cfg=vit_cfg))
    serve = phase_serve_model(torch, new_tokens=new_tokens, B=B, model_name=model_name,
                              device=device, profile=torch.cuda.is_available(),
                              phase="large_serve", token_l2=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    train = phase_train_model(torch, steps=steps, B=B, model_name=model_name, device=device,
                              remat=remat, phase="large_train", profile=profile)
    return {"large_serve": serve["launches"], "large_train": train["launches"]}


def pix2struct_batch(torch, B, pages, max_patches, patch_size, gen, device):
    """B synthetic pages patchified on ``device`` by the port's
    ``patchify_variable_batch`` (one call per page size), page i of size
    ``pages[i % len(pages)]``: the dict ``{patches, rows, cols, mask}``."""
    from pixparse_tpu_torch.ops.pix2struct import patchify_variable_batch

    per_size = -(-B // len(pages))
    made = {hw: patchify_variable_batch(synthetic_pages(torch, per_size, *hw, gen).to(device),
                                        patch_size, max_patches) for hw in pages}
    order = [(pages[i % len(pages)], i // len(pages)) for i in range(B)]
    return {k: torch.stack([made[hw][k][j] for hw, j in order])
            for k in ("patches", "rows", "cols", "mask")}


def pix2struct_lens(max_patches=2048, patch_size=16, pages=PIX2STRUCT_PAGES, B=PIX2STRUCT_B):
    """The pix2struct batch's real patches per page (its ``kv_lens``)."""
    from pixparse_tpu_torch.ops.pix2struct import variable_grid

    grids = [variable_grid(h, w, patch_size, max_patches) for h, w in pages]
    return [math.prod(grids[i % len(pages)]) for i in range(B)]


def phase_pix2struct(torch, model_name="pix2struct_base", B=PIX2STRUCT_B, steps=PIX2STRUCT_STEPS,
                     new_tokens=TASK_NEW_TOKENS, pages=PIX2STRUCT_PAGES, vocab=BART_VOCAB,
                     device="cuda", profile=False):
    """pix2struct_base at full width: 8 pages of four sizes patchified on the
    card (ragged real-patch counts), bf16, seeded weights, EOS off.

    Train: ``pix2struct_pretrain`` from ``TaskFactory`` (a saved byte-level
    tokenizer padded to ``vocab``), auto remat (none under flash), ``steps``
    steps of ``task.train_step`` on one batch: losses finite and falling;
    exact launches a step (depth + 2 x decoder layers flash forward and
    backward, with kv_lens at the encoder and cross sites; one CE forward
    and backward); on 2 of its pages, the task's step-1 loss (2e-2) and
    gradient norm (5e-2) on the kernel path against the plain path, and
    ``step1_kernel_vs_plain``'s own verdict (loss 1e-3, each leaf's gradient
    5e-2 in L2), as finetune_tasks gates it.
    Serve: the encode (depth flash launches), its kernel path against the
    plain path token by token (5e-2 of each token's norm) and both against
    an fp32 plain forward (recorded); padding rows exactly 0; greedy
    ``generate`` with ``encoder_pad_mask`` (2 x decoder layers decode
    launches a step, no flash); cached decode logits against a parallel
    plain pass with the same mask (5e-2/5e-2)."""
    import shutil
    import tempfile

    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.profiling import cruller_train_flops, mfu
    from pixparse_tpu_torch.models.cruller import create_cruller
    from pixparse_tpu_torch.ops.generation import generate
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.task.task_pix2struct_pretrain import (
        TaskPix2StructPretrain,
        TaskPix2StructPretrainCfg,
    )
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    on_card = torch.cuda.is_available()
    env = DeviceEnv.initialize(device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pix2struct_")
    try:
        cfg = TaskPix2StructPretrainCfg(
            model_name=model_name,
            tokenizer=TokenizerCfg(name=saved_tokenizer(os.path.join(tmp, "tok"), vocab)),
            dtype="bfloat16", device=device, num_intervals=1, num_warmup_intervals=0,
            opt=OptimizationCfg(learning_rate=3e-4),
        )
        task, _ = TaskFactory.create_task("pix2struct_pretrain", cfg, env, monitor=None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if type(task) is not TaskPix2StructPretrain or task.vocab_size != vocab:
        raise SystemExit(f"pix2struct: got {type(task).__name__}, vocab {task.vocab_size}")
    enc_cfg, bart_cfg = task.vit_cfg, task.bart_cfg
    gen = torch.Generator().manual_seed(0)
    image = pix2struct_batch(torch, B, pages, enc_cfg.max_patches, enc_cfg.patch_size, gen, device)
    lens = image["mask"].sum(-1).tolist()
    L = task.max_position_embeddings
    text, target = synthetic_tokens(torch, B, L, vocab, gen)
    # the task's input, as a loader hands it over: numpy, unshifted tokens
    sample = ({k: v.cpu().numpy() for k, v in image.items()}, text.numpy(), target.numpy())
    task.train_setup(num_batches_per_interval=steps, seed=0)
    remat = task.model.remat

    # step 1 on 2 pages of different sizes: kernel path against plain path
    # (plain attention keeps (2, 12, 2048, 2048) fp32 scores per layer)
    first = {k: ({n: a[:2] for n, a in v.items()} if isinstance(v, dict) else v[:2])
             for k, v in task._to_device(task.normalize_batch(sample)).items()}
    reset_counts()
    step1 = step1_kernel_vs_plain(torch, task, first, task.model.attn_impl)
    step1["launches"] = read_counts()
    del first
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for _ in range(steps):
        reset_counts()
        sync(torch)
        t0 = time.perf_counter()
        out = task.train_step(sample)
        losses.append(float(out["loss"]))
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_counts())
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    ms_per_step = statistics.median(times[1:]) if steps > 1 else times[0]
    flops = cruller_train_flops(enc_cfg, bart_cfg, B, L - 1)
    train = {
        "task": "pix2struct_pretrain", "remat": remat, "master_dtype": "float32",
        "text_len": L - 1, "steps": steps, "losses": losses, "step_ms": times,
        "ms_per_step": ms_per_step, "samples_per_s": B / (ms_per_step / 1e3),
        "peak_memory_gib": train_peak, "model_flops_per_step": flops,
        "mfu": mfu(flops, ms_per_step / 1e3, device=device), "launches_per_step": per_step[-1],
        "step1_kernel_vs_plain_b2": step1,
    }
    if profile:
        train["profile"] = device_profile(torch, lambda: task.train_step(sample),
                                          "pix2struct_train_step", ms_per_step)
    del task
    if on_card:
        torch.cuda.empty_cache()

    model = create_cruller(enc_cfg, bart_cfg, attn_impl="flash")
    model = model.init_weights(torch.Generator().manual_seed(0)).to(device, torch.bfloat16).eval()
    mask = image["mask"]
    with torch.inference_mode():
        model.encode(image)  # warm-up
        sync(torch)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        enc = model.encode(image)
        sync(torch)
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = read_counts()
        peak_enc = torch.cuda.max_memory_allocated() if on_card else 0
        model.attn_impl = "xla"
        enc_plain = model.encode(image)
        model.attn_impl = "flash"
        enc_err, enc_row_err, enc_ok = rows_close(enc, enc_plain, 5e-2)
        pad_zero = all(bool((enc[b, n:] == 0).all()) for b, n in enumerate(lens))
        vs_fp32 = encoder_vs_fp32(torch, model, image, {"kernel": enc, "plain": enc_plain})
        del enc_plain
        prompt = torch.zeros(B, 1, dtype=torch.long, device=device)  # <s>
        kwargs = dict(max_length=1 + new_tokens, eos_token_id=-1, pad_token_id=1,
                      encoder_pad_mask=mask)
        generate(model, enc, prompt, **dict(kwargs, max_length=9))  # warm-up
        sync(torch)
        if on_card:  # the serving peak: the encode's or the decode's, not the checks'
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = generate(model, enc, prompt, **kwargs)
        sync(torch)
        gen_s = time.perf_counter() - t0
        dec_launches = read_counts()
        serve_peak = (max(peak_enc, torch.cuda.max_memory_allocated()) / 2 ** 30
                      if on_card else None)
        dec_err, dec_ok = cached_vs_parallel(torch, model, enc, res.tokens[:, :16],
                                             encoder_pad_mask=mask)
        prof = None
        if profile:
            prof = {
                "encode": device_profile(torch, lambda: model.encode(image),
                                         "pix2struct_encode", encode_ms),
                "generate": device_profile(torch, lambda: generate(model, enc, prompt, **kwargs),
                                           "pix2struct_generate", gen_s * 1e3),
            }
    dsteps = res.steps
    serve = {
        "encode_ms": encode_ms, "generate_ms": gen_s * 1e3,
        "decode_ms_per_step": gen_s * 1e3 / max(dsteps, 1), "decode_steps": dsteps,
        "pages_per_s": B / (encode_ms / 1e3 + gen_s), "peak_memory_gib": serve_peak,
        "encode_launches": enc_launches, "generate_launches": dec_launches,
        "encode_flash_vs_plain_max_abs_err": enc_err,
        "encode_flash_vs_plain_worst_token_rel_err": enc_row_err,
        "encode_tol": ["token L2", 5e-2], "encode_vs_fp32": vs_fp32, "padding_rows_zero": pad_zero,
        "decode_cached_vs_parallel_max_abs_err": dec_err, "decode_tol": [5e-2, 5e-2],
    }
    if prof:
        serve["profile"] = prof
    rec = {"phase": "pix2struct", "model": model_name, "batch": B, "dtype": "bfloat16",
           "vocab": vocab, "pages": [list(pages[i % len(pages)]) for i in range(B)],
           "kv_lens": lens, "max_patches": enc_cfg.max_patches, "new_tokens": new_tokens,
           "train": train, "serve": serve, "launch_unit": "wrapper calls"}
    emit(rec)

    problems = []
    layers = enc_cfg.depth + 2 * bart_cfg.decoder_layers
    want = dict({k: 0 for k in counters()}, flash_attention_fwd=layers,
                flash_attention_bwd=layers, fused_ce_fwd=1, fused_ce_bwd=1)
    for i, got in enumerate(per_step):
        if on_card and got != want:
            problems.append(f"step {i} launched {got}, want {want}")
            break
    if remat is not False:
        problems.append(f"auto remat gave {remat!r}, want none under flash")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        problems.append(f"non-finite loss: {losses}")
    elif not losses[-1] < losses[0]:
        problems.append(f"loss did not fall on the repeated batch: {losses}")
    k_loss, p_loss = step1["loss"]["kernel"], step1["loss"]["plain"]
    k_gn, p_gn = step1["grad_norm"]["kernel"], step1["grad_norm"]["plain"]
    if abs(k_loss - p_loss) > 2e-2 * abs(p_loss):
        problems.append(f"step-1 loss: kernel path {k_loss} vs plain path {p_loss}")
    if abs(k_gn - p_gn) > 5e-2 * abs(p_gn):
        problems.append(f"step-1 gradient norm: kernel path {k_gn} vs plain path {p_gn}")
    if not step1["ok"]:
        problems.append(f"step 1, kernel path vs plain path, leaf by leaf: {step1}")
    if on_card and enc_launches != dict({k: 0 for k in counters()},
                                        flash_attention_fwd=enc_cfg.depth):
        problems.append(f"encode launched {enc_launches}, want {enc_cfg.depth} flash")
    want_dec = dict({k: 0 for k in counters()},
                    decode_attention=2 * bart_cfg.decoder_layers * dsteps)
    if (on_card and dec_launches != want_dec) or dsteps != new_tokens - 1:
        problems.append(f"generate launched {dec_launches} over {dsteps} steps, want {want_dec}")
    if not enc_ok:
        problems.append(f"flash encoder differs from plain encoder: worst token {enc_row_err}")
    if not pad_zero:
        problems.append("encoder padding rows are not 0")
    if not dec_ok:
        problems.append(f"cached decode logits differ from the parallel pass by {dec_err}")
    if tuple(res.tokens.shape) != (B, 1 + new_tokens):
        problems.append(f"tokens {tuple(res.tokens.shape)}")
    if problems:
        raise SystemExit("pix2struct failed: " + "; ".join(problems))
    return {"pix2struct_train": {k: sum(st[k] for st in per_step) for k in per_step[0]},
            "pix2struct_serve": {k: enc_launches[k] + dec_launches[k] for k in enc_launches}}


# --------------------------------------------------------------------------
# serve_stream: device preprocessing and continuous batching
# --------------------------------------------------------------------------

STREAM_SEED = 17  # the per-page budgets' numpy generator


def stream_task(torch, model_name, tok_dir, device, mode="bf16", device_preprocess=True):
    """The registered ``cruller_eval_ocr`` task, bf16, seed-0 weights."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cfg = TaskCrullerEvalOCRCfg(
        model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
        device=device, kv_cache_dtype=mode, lm_head_dtype=mode,
        device_preprocess=device_preprocess,
    )
    task, _ = TaskFactory.create_task("cruller_eval_ocr", cfg, DeviceEnv.initialize(device))
    task.setup()
    return task


def uint8_canvases(torch, B, H, W, seed):
    """Seeded page-like uint8 canvases ``(B, H, W)`` at the model's size (the
    host transform passes them through without a resize: no PIL)."""
    pages = synthetic_pages(torch, B, H, W, torch.Generator().manual_seed(seed))
    return ((pages + 1.0) * 127.5).round().to(torch.uint8)[..., 0].numpy()


@contextlib.contextmanager
def plain_decode_calls():
    """Counts calls of the two plain decode attentions while it is open."""
    from pixparse_tpu_torch.ops import decode_attention as da

    calls = {"decode_attention_plain": 0, "decode_attention_q8_plain": 0}
    saved = {n: getattr(da, n) for n in calls}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in calls:
        setattr(da, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(da, name, fn)


def stream_preprocess(torch, on, off, canvases, device):
    """(a): one batch through ``encode_images`` with ``device_preprocess``
    on (uint8 over, normalized on the card) and off (normalized on the
    host, float32 over)."""
    import numpy as np

    from pixparse_tpu_torch.ops.preprocess import normalize_images

    x_on = np.stack([on.prepare_image(c) for c in canvases])
    x_off = np.stack([off.prepare_image(c) for c in canvases])
    with torch.inference_mode():
        enc_in = {"on": normalize_images(torch.from_numpy(x_on).to(device), on.img_mean,
                                         on.img_std),
                  "off": torch.from_numpy(x_off).to(device)}
        out = {"on": on.encode_images(x_on), "off": off.encode_images(x_off)}
        out_again = off.encode_images(x_off)
        rec = {"dtypes": [str(x_on.dtype), str(x_off.dtype)], "batch": len(canvases),
               "input_bit_equal": bool(torch.equal(enc_in["on"], enc_in["off"])),
               "output_bit_equal": bool(torch.equal(out["on"], out["off"])),
               "encode_repeats_its_bits": bool(torch.equal(out["off"], out_again))}
        rec["output_max_abs_err"], rec["output_within_serve_model_gate"] = close(
            out["on"], out["off"], 5e-2, 5e-2)
        for name, x, task in (("uint8", x_on, on), ("float32", x_off, off)):
            copies, encodes = [], []
            for _ in range(5):
                sync(torch)
                t0 = time.perf_counter()
                torch.from_numpy(x).to(device)
                sync(torch)
                t1 = time.perf_counter()
                task.encode_images(x)
                sync(torch)
                copies.append((t1 - t0) * 1e3)
                encodes.append((time.perf_counter() - t1) * 1e3)
            rec[f"h2d_{name}"] = {"bytes": int(x.nbytes), "ms": statistics.median(copies),
                                  "encode_images_ms": statistics.median(encodes)}
    rec["ok"] = rec["input_bit_equal"] and (
        rec["output_bit_equal"]
        or (not rec["encode_repeats_its_bits"] and rec["output_within_serve_model_gate"]))
    return rec


def stream_train(torch, model_name, tok_dir, B, vocab, device):
    """(b): one ``cruller_pretrain`` train step with ``device_preprocess``
    on (a uint8 batch) and off (the same batch normalized on the host), from
    the same seed-0 weights."""
    import numpy as np

    from pixparse_tpu_torch.data.transforms import _as_float_normalized
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrainCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    losses = {}
    for flag in (True, False):
        cfg = TaskCrullerPretrainCfg(
            model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
            device=device, num_intervals=2, num_warmup_intervals=0,
            opt=OptimizationCfg(learning_rate=3e-4), device_preprocess=flag)
        task, _ = TaskFactory.create_task("cruller_pretrain", cfg, DeviceEnv.initialize(device))
        task.train_setup(num_batches_per_interval=2, seed=0)
        img8 = uint8_canvases(torch, B, *task.vit_cfg.img_size, seed=5)[..., None]
        text, target = synthetic_tokens(torch, B, task.max_position_embeddings, vocab,
                                        torch.Generator().manual_seed(6))
        image = img8 if flag else np.stack(
            [_as_float_normalized(im, task.img_mean, task.img_std) for im in img8])
        batch = {"image": image, "text": text.numpy(), "target": target.numpy()}
        sync(torch)
        t0 = time.perf_counter()
        losses["on" if flag else "off"] = float(task.train_step(batch)["loss"])
        sync(torch)
        losses[f"{'on' if flag else 'off'}_step_ms"] = (time.perf_counter() - t0) * 1e3
        del task
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    a, b = losses["on"], losses["off"]
    return {**losses, "batch": B, "bit_equal": a == b, "rel_diff": abs(a - b) / abs(b),
            "ok": math.isfinite(a) and math.isfinite(b) and abs(a - b) <= 1e-3 * abs(b)}


def batched_margins(torch, model, enc, tokens, prompt_len, pad, upto):
    """``generate``'s steps replayed on its own output ``tokens`` ``(B, L)``
    (same batch, same caches, same kernels, so the same logits): the top-2
    margin of the logits that chose each column below ``upto``."""
    from pixparse_tpu_torch.models.bart import KVCache
    from pixparse_tpu_torch.ops.generation import _left_align_prompts, q8_logits, quantize_head

    B, L = tokens.shape
    head = quantize_head(model.tied_embedding) if model.lm_head_dtype == "int8" else None
    aligned, positions, valid = _left_align_prompts(tokens[:, :prompt_len], pad)
    buffer = torch.full_like(tokens, pad)
    buffer[:, :prompt_len] = aligned
    cache = KVCache(max_len=L)
    logits = model.decode(aligned, enc, cache, key_pad_mask=buffer != pad, mode="prefill",
                          positions=positions)[:, -1]
    margins = torch.full((B, L), math.nan, device=tokens.device)
    for cur in range(prompt_len, min(upto, L)):
        top = logits.topk(2, dim=-1).values
        margins[:, cur] = top[:, 0] - top[:, 1]
        buffer[:, cur] = tokens[:, cur]
        out = model.decode(tokens[:, cur:cur + 1], enc, cache, key_pad_mask=buffer != pad,
                           mode="decode", positions=(valid + (cur - prompt_len))[:, None],
                           return_hidden=head is not None)
        logits = (out if head is None else q8_logits(out, *head))[:, -1]
    return margins.cpu()


def stream_run(torch, task, canvases, budgets, slots, max_length, device, profile, tag):
    """(c) in one decode mode: the pages through ``ContinuousBatcher`` at
    ``slots`` slots (the task's ``encode_images`` staging pools of 2 x
    slots pages, ``slots`` at a time) and through ``generate`` in batches of
    ``slots`` with the same per-page budgets; EOS off. Returns the record and
    the continuous path's launches."""
    import numpy as np

    from pixparse_tpu_torch.ops.generation import generate
    from pixparse_tpu_torch.ops.serving import ContinuousBatcher

    pad = task.tokenizer.pad_token_id
    prompt = task.prompt_ids(task.task_start_token, 1)[0]
    Lp = len(prompt)
    pages = [task.prepare_image(c) for c in canvases]
    n = len(pages)
    bud = lambda p: int(budgets[p])

    def continuous(ids):
        batcher = ContinuousBatcher(task.model, slots=slots, max_length=max_length,
                                    prompt_ids=prompt, eos_token_id=-1, pad_token_id=pad,
                                    refill_size=slots)
        out, first = [], None
        t0 = time.perf_counter()
        for r in batcher.run(((p, pages[p]) for p in ids), task.encode_images, max_new_tokens=bud):
            first = first or time.perf_counter() - t0
            out.append(r)
        sync(torch)
        return out, batcher, first, time.perf_counter() - t0

    def batched(ids):
        toks, encs, steps, first, gen_s = {}, [], 0, None, 0.0
        t0 = time.perf_counter()
        for lo in range(0, len(ids), slots):
            rows = ids[lo:lo + slots]
            with torch.inference_mode():
                enc = task.encode_images(np.stack([pages[p] for p in rows]))
                t1 = time.perf_counter()
                res = generate(task.model, enc, torch.as_tensor(
                    task.prompt_ids(task.task_start_token, len(rows)), device=device),
                    max_length=max_length, eos_token_id=-1, pad_token_id=pad,
                    max_new_tokens=torch.as_tensor([bud(p) for p in rows], device=device))
            tokens, lengths = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
            gen_s += time.perf_counter() - t1
            first = first or time.perf_counter() - t0
            encs.append((rows, enc, res.tokens))
            steps += res.steps
            for i, p in enumerate(rows):
                toks[p] = tokens[i, :lengths[i]]
        sync(torch)
        return toks, encs, steps, first, time.perf_counter() - t0, gen_s

    continuous(list(range(min(n, 4))))  # warm-up: both paths on a few pages
    batched(list(range(min(n, 2))))
    ids = list(range(n))
    useful = int(sum(bud(p) for p in ids))
    reset_counts()
    with plain_decode_calls() as plain_cont:
        results, batcher, first_c, wall_c = continuous(ids)
    launches_c = read_counts()
    reset_counts()
    with plain_decode_calls() as plain_b:
        toks_b, encs, steps_b, first_b, wall_b, gen_b = batched(ids)
    launches_b = read_counts()
    paths = {
        "continuous": {
            "pages_per_s": n / wall_c, "wall_ms": wall_c * 1e3, "decode_steps": batcher.steps,
            "ms_per_step": wall_c * 1e3 / batcher.steps, "first_result_ms": first_c * 1e3,
            "tokens_per_step": useful / batcher.steps, "launches": launches_c,
            "plain_decode_calls": plain_cont, "refills": batcher.refills,
            "compactions": batcher.compactions, "cache_columns": batcher.C,
            "pool_pages": batcher.G, "max_refill_per_step": batcher.Rm},
        "batched": {
            "pages_per_s": n / wall_b, "wall_ms": wall_b * 1e3, "decode_steps": steps_b,
            "ms_per_step": wall_b * 1e3 / steps_b, "generate_ms_per_step": gen_b * 1e3 / steps_b,
            "first_result_ms": first_b * 1e3, "tokens_per_step": useful / steps_b,
            "launches": launches_b, "plain_decode_calls": plain_b},
    }
    if profile:
        for name, fn, wall in (("continuous", continuous, wall_c), ("batched", batched, wall_b)):
            t0 = time.perf_counter()
            paths[name]["profile"] = device_profile(
                torch, lambda: fn(ids), f"stream_{tag}_{name}", wall * 1e3, cpu=False)
            paths[name]["profile"]["seconds"] = time.perf_counter() - t0

    # each page once; its tokens against the batched path's, to the first
    # disagreement, where the batched path's own top-2 margin must be a bf16 tie
    seen = [r.page_id for r in results]
    got = {r.page_id: r.tokens for r in results}
    first_diff = {}
    for p in ids:
        a, b = got.get(p, np.zeros(0, np.int64)), toks_b[p]
        m = min(len(a), len(b))
        diff = np.flatnonzero(a[:m] != b[:m])
        if len(diff):
            first_diff[p] = int(diff[0])
        elif len(a) != len(b):
            first_diff[p] = m
    disagreements = []
    with torch.inference_mode():
        for rows, enc, tokens in encs:
            at = {p: t for p, t in first_diff.items() if p in rows}
            if not at:
                continue
            margins = batched_margins(torch, task.model, enc, tokens, Lp, pad, max(at.values()) + 1)
            for p, t in at.items():
                i = rows.index(p)
                disagreements.append({"page": p, "first_disagreement": t,
                                      "top2_margin": float(margins[i, t]),
                                      "continuous": int(got[p][t]) if t < len(got[p]) else None,
                                      "batched": int(toks_b[p][t]) if t < len(toks_b[p]) else None})
    rec = {"mode": task.cfg.kv_cache_dtype, "pages": n, "slots": slots, "max_length": max_length,
           "budgets": [int(b) for b in budgets], "generated_tokens": useful, **paths,
           "completion_order": seen, "equal_pages": n - len(first_diff),
           "disagreements": disagreements, "tie_margin": BF16_TIE}
    problems = []
    if sorted(seen) != ids:
        problems.append(f"pages out {sorted(seen)}, want each of {n} once")
    problems += [f"page {d['page']}: differs at {d['first_disagreement']} with a top-2 margin of "
                 f"{d['top2_margin']}" for d in disagreements if not d["top2_margin"] < BF16_TIE]
    lengths = {p: len(got[p]) for p in got}
    if any(lengths[p] != 1 + bud(p) for p in lengths):
        problems.append("a page's length is not its prompt plus its budget (EOS is off)")
    if device == "cuda":
        layers = task.bart_cfg.decoder_layers
        for name, path in paths.items():
            want = dict({k: 0 for k in counters()},
                        flash_attention_fwd=task.vit_cfg.depth * -(-n // slots))
            steps = path["decode_steps"]
            if rec["mode"] == "int8":
                want.update(decode_attention=layers * steps, decode_attention_q8=layers * steps)
            else:
                want.update(decode_attention=2 * layers * steps)
            if path["launches"] != want:
                problems.append(f"{name}: launched {path['launches']}, want {want}")
            if any(path["plain_decode_calls"].values()):
                problems.append(f"{name}: plain decode called {path['plain_decode_calls']}")
    return rec, problems, launches_c


def phase_serve_stream(torch, model_name="cruller_base", pages=STREAM_PAGES, slots=STREAM_SLOTS,
                       max_length=STREAM_MAX_LENGTH, budgets=STREAM_BUDGETS,
                       train_B=STREAM_TRAIN_B, vocab=BART_VOCAB, modes=("bf16", "int8"),
                       device="cuda"):
    """(a) device preprocessing in the eval encode, (b) in a train step,
    (c) continuous batching against batched decode in each decode mode."""
    import shutil
    import tempfile

    import numpy as np

    rec = {"phase": "serve_stream", "model": model_name, "dtype": "bfloat16", "vocab": vocab}
    problems, path_launches = [], {}
    seconds, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name], last[0] = now - last[0], now
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_stream_")
    try:
        tok_dir = saved_tokenizer(os.path.join(tmp, f"tok{vocab}"), vocab)
        on = stream_task(torch, model_name, tok_dir, device)
        off = stream_task(torch, model_name, tok_dir, device, device_preprocess=False)
        lap("tasks")
        H, W = on.vit_cfg.img_size
        rec["preprocess"] = stream_preprocess(torch, on, off, uint8_canvases(torch, slots, H, W, 3),
                                              device)
        if not rec["preprocess"]["ok"]:
            problems.append(f"(a) device preprocessing: {rec['preprocess']}")
        del off
        lap("a")
        rec["train"] = stream_train(torch, model_name, tok_dir, train_B, vocab, device)
        if not rec["train"]["ok"]:
            problems.append(f"(b) train losses {rec['train']}")
        lap("b")
        canvases = uint8_canvases(torch, pages, H, W, 4)
        draws = np.random.default_rng(STREAM_SEED).integers(budgets[0], budgets[1] + 1, pages)
        rec["runs"] = {}
        for mode in modes:
            task = on if mode == "bf16" else stream_task(torch, model_name, tok_dir, device, mode)
            run, bad, launches = stream_run(torch, task, canvases, draws, slots, max_length,
                                            device, torch.cuda.is_available(), mode)
            rec["runs"][mode] = run
            problems += [f"(c) {mode}: {b}" for b in bad]
            path_launches[f"serve_stream_{mode}"] = launches
            if max_length == STREAM_MAX_LENGTH and run["continuous"]["cache_columns"] != STREAM_C:
                problems.append(f"(c) {mode}: {run['continuous']['cache_columns']} cache columns, "
                                f"the kernels phase holds {STREAM_C}")
            del task
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            lap(f"c_{mode}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = seconds
    emit(rec)
    if problems:
        raise SystemExit("serve_stream failed: " + "; ".join(problems))
    return path_launches


# loader: the tar-shard train path, encoded pages to the optimizer step
LOADER_B = 16  # the train batch
LOADER_STEPS = 6  # app.train steps a run (the first one fills the shuffle buffer)
LOADER_PNG = 32  # PNG pages drawn from seeds and written with zlib
LOADER_JPEG_REPEATS = 8  # each of the 4 JPEG fixtures this many times
LOADER_THREADS = (1, 4, 8)  # (b): the loader's worker threads
LOADER_BATCHES = 8  # (b): batches read at each thread count
LOADER_WORKERS = 8  # (c): the train loader's worker threads


def png_bytes(page):
    """A grayscale uint8 (H, W) array as PNG bytes (no filter, zlib), written
    with the standard library only: the card machine has no image encoder."""
    import struct
    import zlib

    import numpy as np

    h, w = page.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), page], axis=1)  # filter byte 0 a row
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def ocr_annotation(seed, lines=40):
    """A ``cruller_pretrain`` annotation of seeded words: one page of lines."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))
    text = [" ".join("".join(rng.choice(letters, rng.randint(1, 11)))
                     for _ in range(rng.randint(4, 12))) for _ in range(lines)]
    return {"pages": [{"text": text}]}


def write_loader_shard(path, page_size, n_png, jpeg_repeats):
    """One tar: ``n_png`` PNG pages of ``page_size`` from seeds, then each JPEG
    fixture ``jpeg_repeats`` times, each with a seeded OCR annotation.
    Returns (the PNG pages' arrays, the JPEG pages' bytes, bytes by kind)."""
    import io
    import tarfile

    from pixparse_tpu_torch.tools.make_page_fixtures import FIXTURE_DIR, N_PAGES, synthetic_page

    pngs = [synthetic_page(100 + i, *page_size) for i in range(n_png)]
    jpegs = [(FIXTURE_DIR / f"page_{i}.jpg").read_bytes() for i in range(N_PAGES)] * jpeg_repeats
    sizes = {"png": 0, "jpg": 0}
    with tarfile.open(path, "w") as tf:
        samples = [("png", png_bytes(p)) for p in pngs] + [("jpg", b) for b in jpegs]
        for i, (ext, data) in enumerate(samples):
            sizes[ext] += len(data)
            for name, blob in ((f"{i:05d}.{ext}", data),
                               (f"{i:05d}.json", json.dumps(ocr_annotation(i)).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    return pngs, jpegs, sizes


def ms_per_item(fn, items):
    """Mean host ms of ``fn`` over ``items`` (one pass, after one warm call)."""
    fn(items[0])
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    return (time.perf_counter() - t0) * 1e3 / len(items)


@contextlib.contextmanager
def recorded_train_steps(torch, task_cls, profile_from=None, profile_to=None):
    """Wraps ``task_cls.train_step`` (the class attribute, so the tasks an
    entry point builds inside itself are caught) for the duration. Each
    step's loss is read (so the step has ended) and its entry and exit times,
    and a copy of the first step's batch, land in the yielded record. With
    ``profile_from``, ``torch.profiler`` traces the card from the exit of
    that step to the exit of step ``profile_to`` (1-based)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    rec = {"enter": [], "exit": [], "losses": [], "first_batch": None, "prof": None}
    own = task_cls.__dict__.get("train_step")
    step = task_cls.train_step

    def recorded(self, sample):
        rec["enter"].append(time.perf_counter())
        if rec["first_batch"] is None:
            rec["first_batch"] = copy.deepcopy(sample)
        out = step(self, sample)
        rec["losses"].append(float(out["loss"]))
        sync(torch)
        rec["exit"].append(time.perf_counter())
        n = len(rec["exit"])
        if n == profile_from:
            rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
            rec["prof"].start()
        elif n == profile_to and rec["prof"] is not None:
            rec["prof"].stop()
        return out

    task_cls.train_step = recorded
    try:
        yield rec
    finally:
        if own is None:
            del task_cls.train_step
        else:
            task_cls.train_step = own


def step_summary(torch, rec, steps, tag, on_card):
    """ms a step (exit to exit) and loader wait (the previous step's exit to
    this step's entry) of steps 2..``steps``, their medians, and, on the
    card, the device's busy ms and idle share over that window."""
    enter, exit_ = rec["enter"], rec["exit"]
    step_ms = [(exit_[i] - exit_[i - 1]) * 1e3 for i in range(1, len(exit_))]
    wait_ms = [(enter[i] - exit_[i - 1]) * 1e3 for i in range(1, len(exit_))]
    out = {"steps": len(exit_), "losses": rec["losses"], "step_ms": step_ms, "wait_ms": wait_ms,
           "ms_per_step": statistics.median(step_ms) if step_ms else None,
           "wait_ms_per_step": statistics.median(wait_ms) if wait_ms else None}
    if on_card and rec["prof"] is not None:
        from torch.autograd import DeviceType

        events = rec["prof"].key_averages()
        with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
            fh.write(events.table(sort_by="self_device_time_total", row_limit=30))
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e3
        wall = (exit_[-1] - exit_[0]) * 1e3
        out.update(device_ms=busy, window_wall_ms=wall, idle_share=1.0 - busy / wall)
    return out


def loader_task_cfg(model_name, tok_dir, device, flag):
    """The ``cruller_pretrain`` config the ``loader`` phase's app.train
    arguments give (bf16, one interval, no warm-up)."""
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrainCfg
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    return TaskCrullerPretrainCfg(
        model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
        device=device, num_intervals=1, num_warmup_intervals=0, device_preprocess=flag)


def native_skip_reason(err):
    """The missing header or library a failed native build names, if that is
    why it failed."""
    import re

    m = (re.search(r"fatal error: ([\w./+-]+): No such file", err)
         or re.search(r"cannot find (-l[\w+-]+)", err))
    return m.group(1) if m else None


def phase_loader(torch, model_name="cruller_base", B=LOADER_B, steps=LOADER_STEPS,
                 page_size=None, n_png=LOADER_PNG, jpeg_repeats=LOADER_JPEG_REPEATS,
                 threads=LOADER_THREADS, loader_batches=LOADER_BATCHES,
                 workers=LOADER_WORKERS, vocab=BART_VOCAB, device="cuda"):
    """The tar-shard train path: (a) native decode and the legacy transform,
    (b) the loader alone by worker threads, (c) ``app.train`` from the shard
    with ``device_preprocess`` off and on, beside ``cruller_pretrain`` on
    seeded in-memory batches (train_task's path). Returns the launch counts
    of the three train runs."""
    import gc
    import importlib.util
    import logging
    import shutil
    import tempfile
    import threading

    import numpy as np

    from pixparse_tpu_torch import native
    from pixparse_tpu_torch.app import train as app_train
    from pixparse_tpu_torch.data import wds
    from pixparse_tpu_torch.data.transforms import create_transforms
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.train import train_one_interval
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrain
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tools.make_page_fixtures import PAGE_SIZE

    on_card = torch.cuda.is_available() and device != "cpu"
    window = (1, steps) if on_card else ()  # the profiled steps: 2..steps
    page_size = tuple(page_size or PAGE_SIZE)
    rec = {"phase": "loader", "nvidia_smi": nvidia_smi() if on_card else None,
           "cpu_count": os.cpu_count(), "model": model_name, "batch": B,
           # whether PIL and cv2 are installed here (none of the phase's paths uses them)
           "importable": {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}}
    seconds = {}
    t_lap = time.perf_counter()

    def lap(name):
        nonlocal t_lap
        now = time.perf_counter()
        seconds[name] = now - t_lap
        t_lap = now

    if native.load_native() is None:
        err = native.build_error() or ""
        missing = native_skip_reason(err)
        if missing is None:
            raise SystemExit(f"loader: the native library failed to build or load:\n{err}")
        emit({**rec, "skipped": f"the native library cannot build here: {missing} is missing"})
        return {}
    lap("native_build")
    problems, path_launches = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        shard = os.path.join(tmp, "shard-00000.tar")
        pngs, jpegs, sizes = write_loader_shard(shard, page_size, n_png, jpeg_repeats)
        n_pages = len(pngs) + len(jpegs)
        rec["shard"] = {"pages": n_pages, "png_pages": len(pngs), "jpeg_pages": len(jpegs),
                        "page_size": page_size, "bytes": os.path.getsize(shard),
                        "png_bytes": sizes["png"], "jpeg_bytes": sizes["jpg"]}
        lap("shard")
        tok_dir = saved_tokenizer(os.path.join(tmp, f"tokenizer{vocab}"), vocab)
        env = DeviceEnv.initialize(device)
        task, _ = TaskFactory.create_task(
            "cruller_pretrain", loader_task_cfg(model_name, tok_dir, device, False), env)
        img_size = tuple(task.vit_cfg.img_size)

        # (a) decode, transform and tokenization, ms a page on the host
        png_data = [png_bytes(p) for p in pngs]
        decoded = [native.decode_image(d, gray=True) for d in png_data]
        exact = sum(bool(out is not None and np.array_equal(out[:, :, 0], p))
                    for out, p in zip(decoded, pngs))
        if exact != len(pngs):
            problems.append(f"(a) {len(pngs) - exact} PNG pages did not decode to their arrays")
        scaled = native.decode_image(jpegs[0], gray=True, target_size=img_size)
        per_page = [("png", d) for d in png_data] + [("jpg", d) for d in jpegs]
        transforms = {norm: create_transforms("legacy", img_size, training=True,
                                              image_mean=task.img_mean, image_std=task.img_std,
                                              normalize=norm) for norm in (True, False)}
        arrays = [wds.decode_image_bytes(d, ext, "L", target_size=img_size) for ext, d in per_page]
        native.reset_calls()
        for ext, d in per_page:
            transforms[True](wds.decode_image_bytes(d, ext, "L", target_size=img_size))
        calls = {"decode_image": native.decode_image.calls,
                 "resize_filter": native.resize_filter.calls}
        if calls != {"decode_image": n_pages, "resize_filter": n_pages}:
            problems.append(f"(a) native calls {calls} over {n_pages} pages")
        anno = [json.dumps(ocr_annotation(i)).encode() for i in range(n_pages)]
        rec["decode"] = {
            "png_ms": ms_per_item(lambda d: native.decode_image(d, gray=True), png_data),
            "jpeg_full_ms": ms_per_item(lambda d: native.decode_image(d, gray=True), jpegs),
            "jpeg_scaled_ms": ms_per_item(
                lambda d: native.decode_image(d, gray=True, target_size=img_size), jpegs),
            "jpeg_scaled_shape": list(scaled.shape) if scaled is not None else None,
            "jpeg_full_shape": list(native.decode_image(jpegs[0], gray=True).shape),
            **{f"legacy_{'float' if norm else 'uint8'}_ms": ms_per_item(tf, arrays)
               for norm, tf in transforms.items()},
            **{f"decode_legacy_{'float' if norm else 'uint8'}_ms": ms_per_item(
                lambda p, tf=tf: tf(wds.decode_image_bytes(p[1], p[0], "L", target_size=img_size)),
                per_page) for norm, tf in transforms.items()},
            "annotation_ms": ms_per_item(
                lambda a: task.anno_preprocess_train(json.loads(a)), anno),
            "native_calls": calls, "png_exact": exact,
        }
        del decoded, arrays
        lap("decode")

        # (b) the loader alone: decoded pages and batches a second by threads
        rec["loader"] = {}
        count_lock = threading.Lock()  # the counters below are bumped by loader threads
        for n in threads:
            count = {"pages": 0}
            pipe = wds.create_doc_anno_pipe(task.image_preprocess_train,
                                            task.anno_preprocess_train, image_fmt="L")

            def counted(sample, pipe=pipe, count=count):
                out = pipe(sample)
                with count_lock:
                    count["pages"] += out is not None
                return out

            bundle = wds.create_wds_loader(shard, counted, is_train=True,
                                           num_samples=B * loader_batches, workers=n,
                                           batch_size=B, collate_fn=task.collate_fn)
            t0 = time.perf_counter()
            got, t_first, at_first = 0, None, 0
            for batch in bundle.loader:
                got += 1
                if got == 1:  # the shuffle buffer is full from here on
                    t_first, at_first = time.perf_counter() - t0, count["pages"]
            dt = time.perf_counter() - t0
            pages = count["pages"]
            rec["loader"][str(n)] = {
                "batches": got, "seconds": dt, "first_batch_s": t_first, "pages_decoded": pages,
                "decoded_per_s": pages / dt, "samples_per_s": got * B / dt,
                "after_first_decoded_per_s": (pages - at_first) / (dt - t_first)
                if got > 1 else None}
            if got != loader_batches:
                problems.append(f"(b) {n} threads: {got} batches, want {loader_batches}")
        lap("loader")
        del task

        # (c) app.train from the shard, device_preprocess off and on, then
        # cruller_pretrain on seeded in-memory batches
        rec["train"] = {}
        first_batches = {}
        for flag in (False, True):
            tag = f"app_train_dp{int(flag)}"
            counts = {"native": 0, "other": 0}
            decode_bytes = wds.decode_image_bytes

            def counted_decode(*args, **kwargs):
                out = decode_bytes(*args, **kwargs)
                with count_lock:
                    counts["native" if isinstance(out, np.ndarray) else "other"] += 1
                return out

            argv = ["--train.task_name", "cruller_pretrain", "--train.experiment", tag,
                    "--train.output_dir", os.path.join(tmp, "out"), "--train.seed", "42",
                    "--task.model_name", model_name, "--task.tokenizer.name", tok_dir,
                    "--task.dtype", "bfloat16", "--task.device", device,
                    "--task.num_intervals", "1", "--task.num_warmup_intervals", "0",
                    "--task.device_preprocess", str(flag).lower(),
                    "--data.train.source", shard, "--data.train.split", "train",
                    "--data.train.num_samples", str(B * steps),
                    "--data.train.batch_size", str(B), "--data.train.num_workers", str(workers)]
            root = logging.getLogger()
            handlers, level = root.handlers[:], root.level
            wds.decode_image_bytes = counted_decode
            reset_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                with recorded_train_steps(torch, TaskCrullerPretrain, *window) as steps_rec:
                    rc = app_train.main(argv)
            finally:
                wds.decode_image_bytes = decode_bytes
                root.handlers[:] = handlers
                root.setLevel(level)
            run = {"rc": rc, "seconds": time.perf_counter() - t0, "launches": read_counts(),
                   "pages_decoded": dict(counts),
                   **step_summary(torch, steps_rec, steps, f"loader_{tag}", on_card)}
            if on_card:
                run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            first_batches[flag] = steps_rec["first_batch"]
            path_launches[f"loader_{tag}"] = run["launches"]
            rec["train"][tag] = run
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            lap(tag)

        # the same seeded model on each run's first batch, fed as arrays
        for flag in (False, True):
            run = rec["train"][f"app_train_dp{int(flag)}"]
            ref, _ = TaskFactory.create_task(
                "cruller_pretrain", loader_task_cfg(model_name, tok_dir, device, flag), env)
            ref.train_setup(num_batches_per_interval=steps, seed=42)
            loss = float(ref.train_step(first_batches[flag])["loss"])
            step1 = run["losses"][0] if run["losses"] else math.nan
            run["step1_vs_arrays"] = {"loader": step1, "arrays": loss,
                                      "rel_diff": abs(step1 - loss) / abs(loss)}
            if not (math.isfinite(step1) and abs(step1 - loss) <= 1e-3 * abs(loss)):
                problems.append(f"(c) dp{int(flag)}: step-1 loss {step1} against {loss} "
                                "from the same batch as arrays")
            del ref
            gc.collect()
        lap("step1_reference")

        task, _ = TaskFactory.create_task(
            "cruller_pretrain", loader_task_cfg(model_name, tok_dir, device, False), env)
        loader = SeededLoader(torch, steps, B, img_size, task.max_position_embeddings, seed=18,
                              in_chans=task.vit_cfg.in_chans, vocab=vocab)
        task.train_setup(num_batches_per_interval=steps, seed=42)
        reset_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_train_steps(torch, TaskCrullerPretrain, *window) as steps_rec:
            train_one_interval(task, loader)
        synth = {"seconds": time.perf_counter() - t0, "launches": read_counts(),
                 **step_summary(torch, steps_rec, steps, "loader_synthetic", on_card)}
        if on_card:
            synth["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["train"]["synthetic"] = synth
        path_launches["loader_synthetic"] = synth["launches"]
        del task
        lap("synthetic")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want = {k: n / steps for k, n in rec["train"]["synthetic"]["launches"].items()}
    for tag in ("app_train_dp0", "app_train_dp1"):
        run = rec["train"][tag]
        if run["rc"] != 0 or run["steps"] != steps:
            problems.append(f"(c) {tag}: exit {run['rc']}, {run['steps']} steps, want {steps}")
        if run["pages_decoded"]["other"] or not run["pages_decoded"]["native"]:
            problems.append(f"(c) {tag}: pages decoded {run['pages_decoded']}, all native wanted")
        per_step = {k: n / max(1, run["steps"]) for k, n in run["launches"].items()}
        if per_step != want:
            problems.append(f"(c) {tag}: launches a step {per_step}, train_task's {want}")
        if not all(math.isfinite(x) for x in run["losses"]):
            problems.append(f"(c) {tag}: losses {run['losses']}")
    if on_card:
        missing = [k for k in TRAIN_KERNELS["cruller_base"] if want.get(k, 0) <= 0]
        if missing:
            problems.append(f"(c) the train path never launched {missing}")
    rec["seconds"] = seconds
    emit(rec)
    if problems:
        raise SystemExit("loader failed: " + "; ".join(problems))
    return path_launches


# the wgmma kernels, by (mangled) name fragment; their dynamic shared memory
# per template argument, as FwdCfg / BwdCfg (flash, by head dim) and GemmCfg
# (the CE backward's products, by output tile width BN) lay it out
WGMMA_FLASH = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")
WGMMA_CE = ("ce_gemm_kernel",)
CE_PRODUCTS = ("K1_g", "K2_dE", "K3_dh", "F_lse")  # by the template's product index
CE_FWD = ("ce_gemm_kernel", "ce_lse_merge_kernel")  # ce_fwd_ptxas: product F and the merge
DECODE = ("decode_attn_split_kernel",)
Q8_LN = ("decode_attn_q8_kernel", "ln_bwd_kernel", "ln_fwd_kernel")  # template arguments as parsed
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
            elif name in Q8_LN:
                cur = {"kernel": name, "dtype": "bf16" if "bfloat16" in m.group(1) else "fp32",
                       "template": [int(x) for x in re.findall(r"Li(\d+)E", m.group(1))]}
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


# --------------------------------------------------------------------------
# distributed: the mesh path in a torchrun child of one rank
# --------------------------------------------------------------------------

DIST_B = 16  # the train batch
DIST_STEPS = 6  # train steps of each run (the first one warms up)
DIST_EVAL = (16, 2, 48)  # evaluate: batch, batches, reference length
DIST_LOSS_RTOL = 1e-3  # step 1: the mesh step's loss against the process alone
DIST_NORM_RTOL = 1e-2  # step 1: its gradient norm
DIST_CHILD_TIMEOUT_S = 300  # the child's limit; the phase takes well under 90 s
CPU_CHILD_THREADS = 2  # a CPU child's intra-op threads (the CPU tests' gloo ranks take as many)
DIST_STEP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")
DIST_EVAL_KERNELS = ("flash_attention_fwd", "decode_attention")


def phase_distributed(torch, model_name="cruller_base", B=DIST_B, steps=DIST_STEPS,
                      vocab=BART_VOCAB, eval_run=DIST_EVAL, device="cuda", profile=False):
    """The mesh path, in a child started by ``torch.distributed.run
    --standalone --nproc_per_node 1`` so that its process group (NCCL on
    the card) ends with the phase: :func:`distributed_child` does the work
    and writes its record; a child that fails fails the phase. Returns the
    mesh runs' launch counts."""
    out = os.path.abspath(os.path.join(OUT_DIR, "distributed.json"))
    log_path = os.path.abspath(os.path.join(OUT_DIR, "distributed_child.log"))
    if os.path.exists(out):
        os.remove(out)
    spec = {"model_name": model_name, "B": B, "steps": steps, "vocab": vocab,
            "eval_run": list(eval_run), "device": device, "profile": profile, "out": out,
            "out_dir": os.path.abspath(OUT_DIR)}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":  # beside other busy processes: no more threads than it needs
        env["OMP_NUM_THREADS"] = str(CPU_CHILD_THREADS)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the child shares the card
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           os.path.abspath(__file__), "--distributed-child", json.dumps(spec)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        # a session of its own: on a timeout the launcher and its worker go together
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here,
                                start_new_session=True)
        try:
            proc.wait(timeout=DIST_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise SystemExit(f"distributed: the torchrun child ran past {DIST_CHILD_TIMEOUT_S} s "
                             f"and was killed (its log: {log_path})")
    wall_s = time.perf_counter() - t0
    with open(log_path) as fh:
        tail = fh.read()[-4000:]
    if proc.returncode != 0 or not os.path.exists(out):
        print(tail, file=sys.stderr)
        raise SystemExit(f"distributed: the torchrun child exited {proc.returncode} "
                         f"(its log: {log_path})")
    with open(out) as fh:
        rec = json.load(fh)
    rec["wall_s"] = wall_s
    emit(rec)
    if rec["problems"]:
        raise SystemExit("distributed failed: " + "; ".join(rec["problems"]))
    mesh = rec["runs"]["mesh"]
    return {"distributed": {k: mesh["launches"][k] + rec["eval"]["mesh"]["launches"][k]
                            for k in mesh["launches"]}}


def distributed_child(spec) -> int:
    """One rank of ``torch.distributed.run``: ``MeshEnv.initialize`` makes
    the world of one (NCCL on the card, gloo on the CPU) and its mesh
    (data=1, fsdp=1, model=1). ``cruller_pretrain`` as ``train_task`` builds
    it, once in that mesh (FSDP2-wrapped) and once as a process alone, from
    the same seed and batch: ``steps`` steps each through the task's
    ``train_step``; then ``evaluate`` over ``cruller_eval_ocr`` in each,
    merged through ``app.eval``. Writes the record to ``spec['out']``; exits
    1 when a check failed."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pixparse_tpu_torch.parallel.mesh import MeshEnv

    global OUT_DIR
    OUT_DIR = spec["out_dir"]
    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(CPU_CHILD_THREADS)
    env = MeshEnv.initialize(data=1, fsdp=1, model=1, device=spec["device"])
    try:
        with nan_default_init(torch):
            rec = distributed_runs(torch, env, spec)
    finally:
        env.close()
    with open(spec["out"], "w") as fh:
        json.dump(rec, fh)
    return 1 if rec["problems"] else 0


def distributed_runs(torch, env, spec):
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pixparse_tpu_torch.app.eval import EvalCfg, eval as eval_app
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.parallel.mesh import MeshEnv, is_sharded
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrainCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    model_name, B, steps, vocab, device = (spec[k] for k in ("model_name", "B", "steps", "vocab",
                                                             "device"))
    on_card = device == "cuda"
    envs = (("alone", MeshEnv(device=env.device)), ("mesh", env))  # no mesh: a process alone
    rec = {"phase": "distributed", "backend": dist.get_backend(),
           "world_size": dist.get_world_size(), "env": str(env), "task": "cruller_pretrain",
           "model_name": model_name, "batch": B, "steps": steps, "vocab": vocab,
           "dtype": "bfloat16", "runs": {}, "eval": {}, "problems": []}
    problems = rec["problems"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    try:
        tok_dir = saved_tokenizer(os.path.join(tmp, f"tokenizer{vocab}"), vocab)
        cfg = TaskCrullerPretrainCfg(
            model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
            device=device, num_intervals=2, num_warmup_intervals=0,
            opt=OptimizationCfg(learning_rate=3e-4),
        )
        for tag, task_env in envs:
            task, _ = TaskFactory.create_task("cruller_pretrain", cfg, task_env, monitor=None)
            enc = task.vit_cfg
            loader = SeededLoader(torch, 1, B, enc.img_size, task.max_position_embeddings,
                                  seed=0, in_chans=enc.in_chans, vocab=vocab)
            task.train_setup(num_batches_per_interval=steps, seed=0)
            step_fn, seen = task.train_step_fn, []

            def recording(state, batch, step_fn=step_fn, seen=seen):
                state, metrics = step_fn(state, batch)
                seen.append(metrics)
                return state, metrics

            task.train_step_fn = recording
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync(torch)
            reset_counts()
            ms = []
            for _ in range(steps):  # the task's entry point, as train_one_interval calls it
                t0 = time.perf_counter()
                task.train_step(loader.batches[0])
                float(task._last_loss_dev)
                sync(torch)
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts()
            step_ms = statistics.median(ms[1:])
            run = {
                "fsdp2_wrapped": any(is_sharded(p) for p in task.state.params.values()),
                "model_class": type(task.model).__name__,
                "losses": [float(m["loss"]) for m in seen],
                "grad_norms": [float(m["grad_norm"]) for m in seen],
                "ms_per_step": step_ms, "ms_by_step": ms, "samples_per_s": B / step_ms * 1e3,
                "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "launches": launches,
                "launches_per_step": {k: launches[k] / steps for k in DIST_STEP_KERNELS},
            }
            if spec["profile"] and on_card:
                batch = task._to_device(task.normalize_batch(loader.batches[0]))
                run["profile"] = device_profile(
                    torch, lambda: task.train_step_fn(task.state, batch),
                    f"distributed_{tag}_step", step_ms, match="nccl", cpu_table=True)
            rec["runs"][tag] = run
            del task, recording, step_fn
            gc.collect()  # the task and its step close a cycle: free it before the next run
            if on_card:
                torch.cuda.empty_cache()

        alone, mesh = rec["runs"]["alone"], rec["runs"]["mesh"]
        if not mesh["fsdp2_wrapped"] or alone["fsdp2_wrapped"]:
            problems.append(f"wrapped: mesh {mesh['fsdp2_wrapped']}, alone {alone['fsdp2_wrapped']}")
        for tag, run in rec["runs"].items():
            if not all(np.isfinite(run["losses"])):
                problems.append(f"{tag}: losses not finite: {run['losses']}")
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
        rec["step1"] = {"loss_rel": rel(mesh["losses"][0], alone["losses"][0]),
                        "grad_norm_rel": rel(mesh["grad_norms"][0], alone["grad_norms"][0])}
        if not rec["step1"]["loss_rel"] <= DIST_LOSS_RTOL:
            problems.append(f"step-1 loss: mesh {mesh['losses'][0]} vs alone {alone['losses'][0]}")
        if not rec["step1"]["grad_norm_rel"] <= DIST_NORM_RTOL:
            problems.append(f"step-1 grad norm: mesh {mesh['grad_norms'][0]} vs alone "
                            f"{alone['grad_norms'][0]}")
        if mesh["launches_per_step"] != alone["launches_per_step"]:
            problems.append(f"launches a step: mesh {mesh['launches_per_step']} vs alone "
                            f"{alone['launches_per_step']}")
        if on_card and not all(n > 0 for n in mesh["launches_per_step"].values()):
            problems.append(f"the mesh step never launched some kernels: {mesh['launches_per_step']}")

        EB, n_batches, length = spec["eval_run"]
        for tag, task_env in envs:
            task = eval_task_setup(torch, model_name, "bf16", tok_dir, device, env=task_env)
            enc = task.vit_cfg
            loader = SeededLoader(torch, n_batches, EB, enc.img_size, length, vocab, enc.in_chans,
                                  BYTE_IDS[1])
            eval_cfg = EvalCfg(metrics_file_path=os.path.join(tmp, f"{tag}-metrics.json"))
            sync(torch)
            reset_counts()
            t0 = time.perf_counter()
            metrics = eval_app(eval_cfg, task, {"eval": loader})
            sync(torch)
            dt = time.perf_counter() - t0
            rec["eval"][tag] = {"metrics": metrics, "seconds": dt,
                                "pages_per_s": EB * n_batches / dt, "launches": read_counts()}
            del task
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        got, want = rec["eval"]["mesh"]["metrics"], rec["eval"]["alone"]["metrics"]
        avg = want.get("eval", {}).get("average", {})
        if got != want or not all(k in avg and np.isfinite(avg[k]) for k in ("cer", "wer")):
            problems.append(f"eval metrics: mesh {got} vs alone {want}")
        eval_launches = rec["eval"]["mesh"]["launches"]
        if on_card and not all(eval_launches[k] > 0 for k in DIST_EVAL_KERNELS):
            problems.append(f"the mesh eval never launched some kernels: {eval_launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


# --------------------------------------------------------------------------
# tensor_parallel: the model axis' kernel shapes, then two ranks on one card
# --------------------------------------------------------------------------

TP_SIZES = (2, 4)  # the model axis' sizes whose shard shapes (a) checks
TP_B = 16  # (b): the train batch
TP_STEPS = 2  # (b): cruller_base train steps of each run (step 1 is the one gated)
TP_CHILD_TIMEOUT_S = 600  # (b)'s torchrun child; it takes ~2 min on the card
TP_FLASH = (  # cruller_base's train step: name, B, Lq, Lk, H, D, causal
    ("encoder_b16_l1009", 16, 1009, 1009, 12, 64, False),
    ("decoder_self_causal_b16_l1023", 16, 1023, 1023, 12, 64, True),
    ("decoder_cross_b16_lq1023_lk1009", 16, 1023, 1009, 12, 64, False),
)
# #8 at cruller_base's decode (B=16, prompt 1 + TP_DECODE_NEW_TOKENS): name, B,
# Lk, valid keys, H, D
TP_DECODE_CASES = (
    ("cross_b16_lk1024_valid1009", 16, 1024, 1009, 12, 64),
    ("self_b16_lk128_valid33", 16, 128, 33, 12, 64),
)
TP_DECODE_B = 16  # (b): the model-parallel decode's batch
TP_DECODE_NEW_TOKENS = 32  # (b): its new tokens, EOS off
TP_DECODE_GATE = 5e-2  # (b): logits against alone's, the cached-decode gate (abs and rel)
TP_P2S_B = 8  # (b): pix2struct_base's train batch at (1,1,2)
TP_P2S_STEPS = 2
TP_P2S_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")
TP_DECODE_KERNELS = ("flash_attention_fwd", "decode_attention")
TP_CE = ("train_t16368_v50265_d768", 16 * 1023, BART_VOCAB, 768, 0.3)  # name, T, V, D, ignored
TP_WINDOW_STAGES = ((128, 4), (256, 8), (512, 16), (1024, 32))  # donut_base: C, H by stage
# the combined (merged) results against the unsharded kernel's: the shards
# run the same kernels on the same rows, so only the CE's merge and dh's
# sum over the shards reorder sums
TP_COMBINED_TOL = TOL["bfloat16"]


def tp_timing(torch, timer, rec, kernel, plain, library, flops, nbytes, peaks):
    """Times one shard's kernel call beside its plain version and the
    library call; its bound from this shard's work."""
    peak_bf16, _, bw = peaks
    t_ops, t_mem = flops / peak_bf16, nbytes / bw
    rec.update(bound_ms=max(t_ops, t_mem) * 1e3,
               bound_by="operations" if t_ops >= t_mem else "bytes")
    rec["ms"] = timer.median_ms(kernel, n=10)
    rec["plain_ms"] = timer.median_ms(plain, n=3, warmup=1)
    rec["library_ms"] = timer.median_ms(library, n=10) if library is not None else None
    rec.update(speed_shares(rec) if library is not None else {})
    return rec


def tp_flash_cases():
    """``TP_FLASH`` (no kv_lens) and pix2struct_base's encoder and cross
    sites with the pix2struct phase's ragged kv_lens: name, B, Lq, Lk, H,
    D, causal, kv_lens."""
    lens = pix2struct_lens()
    return [case + (None,) for case in TP_FLASH] + [
        ("p2s_encode_b8_l2048_kv_lens", PIX2STRUCT_B, 2048, 2048, 12, 64, False, lens),
        ("p2s_cross_b8_lq1023_lk2048_kv_lens", PIX2STRUCT_B, 1023, 2048, 12, 64, False, lens),
    ]


def tp_flash(torch, F, fa, timer, peaks, gen, case, size):
    """Flash forward and backward on each rank's heads of the same full
    q/k/v (each rank's own fused projection: its heads of q, k and v,
    contiguous), against the plain version per rank and, heads
    concatenated, against the unsharded kernel. Returns (forward record,
    backward record); the timings are rank 0's shard."""
    name, B, Lq, Lk, H, D, causal, lens = case
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, kv_lens=kv_lens)
    dt = torch.bfloat16
    Hl = H // size
    if Lq == Lk:
        qkv = torch.randn(B, Lq, 3, H, D, generator=gen).to("cuda", dt)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(B, Lq, H, D, generator=gen).to("cuda", dt)
        kv = torch.randn(B, Lk, 2, H, D, generator=gen).to("cuda", dt)
        k, v = kv.unbind(2)
    do = torch.randn(B, Lq, H, D, generator=gen).to("cuda", dt)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
    atol, rtol = TOL["bfloat16"]
    brtol = BWD_ROW_RTOL["bfloat16"]
    fwd_errs, bwd_errs, shards, ok_f, ok_b = [], [], [], True, True
    for r in range(size):
        hs = slice(r * Hl, (r + 1) * Hl)
        if Lq == Lk:
            qr, kr, vr = qkv[:, :, :, hs].contiguous().unbind(2)
        else:
            qr = q[:, :, hs].contiguous()
            kr, vr = kv[:, :, :, hs].contiguous().unbind(2)
        dor = do[:, :, hs].contiguous()
        o_r, lse_r = fa.flash_attention_fwd(qr, kr, vr, **kw)
        o_ref, lse_ref = fa.flash_attention_plain(qr, kr, vr, **kw)
        e_o, k_o = close(o_r, o_ref, atol, rtol)
        e_l, k_l = close(lse_r, lse_ref, *LSE_TOL)
        fwd_errs.append(max(e_o, e_l))
        ok_f = ok_f and k_o and k_l
        delta_r = (dor.float() * o_r.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (qr, kr, vr, dor, lse_r, delta_r)
        g_r = fa.flash_attention_bwd(*args, **kw)
        g_ref = fa.flash_attention_bwd_plain(*args, **kw)
        errs = [rows_close(a, b, brtol, BWD_ROW_FLOOR) for a, b in zip(g_r, g_ref)]
        bwd_errs.append(max(e[0] for e in errs))
        ok_b = ok_b and all(e[2] for e in errs)
        shards.append((o_r, lse_r, g_r, args))
        del o_ref, lse_ref, g_ref
    comb_o, ok_co = close(torch.cat([s[0] for s in shards], 2), o, *TP_COMBINED_TOL)
    comb_l, ok_cl = close(torch.cat([s[1] for s in shards], 1), lse, *LSE_TOL)
    comb_g = [rows_close(torch.cat([s[2][i] for s in shards], 2), grads[i], brtol,
                         BWD_ROW_FLOOR) for i in range(3)]
    common = dict(case=name, model=size, full_shape=[B, Lq, Lk, H, D],
                  shard_shape=[B, Lq, Lk, Hl, D], causal=causal, kv_lens=lens, dtype=str(dt))
    fwd = dict(common, max_abs_err=max(fwd_errs), rank_max_abs_err=fwd_errs,
               combined_max_abs_err=max(comb_o, comb_l), tol=[atol, rtol, "lse", *LSE_TOL],
               ok=ok_f and ok_co and ok_cl)
    bwd = dict(common, max_abs_err=max(bwd_errs), rank_max_abs_err=bwd_errs,
               combined_max_abs_err=max(g[0] for g in comb_g),
               combined_worst_row_rel_err=max(g[1] for g in comb_g),
               tol=["row L2", brtol, "floor", BWD_ROW_FLOOR],
               ok=ok_b and all(g[2] for g in comb_g))
    qr, kr, vr = shards[0][3][:3]
    pairs, kl = visible_pairs(B, Lq, Lk, causal, lens)
    elt = 2
    qt, kt, vt = qr.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2)
    am = None
    if kv_lens is not None:
        am = (torch.arange(Lk, device="cuda")[None] < kv_lens[:, None])[:, None, None, :]
    elif causal and Lq != Lk:
        am = torch.arange(Lk, device="cuda")[None, :] <= (
            torch.arange(Lq, device="cuda")[:, None] + (Lk - Lq))
    sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am) if am is not None \
        else F.scaled_dot_product_attention(*t, is_causal=causal)
    tp_timing(torch, timer, fwd, lambda: fa.flash_attention_fwd(qr, kr, vr, **kw),
              lambda: fa.flash_attention_plain(qr, kr, vr, **kw), lambda: sdpa(qt, kt, vt),
              4.0 * Hl * D * pairs, elt * Hl * D * (2 * B * Lq + 2 * sum(kl)) + 4 * B * Hl * Lq,
              peaks)
    args = shards[0][3]
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in args[:3]]
    out = sdpa(*leaves)
    dot = args[3].transpose(1, 2)
    tp_timing(torch, timer, bwd, lambda: fa.flash_attention_bwd(*args, **kw),
              lambda: fa.flash_attention_bwd_plain(*args, **kw),
              lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True),
              10.0 * Hl * D * pairs,
              elt * Hl * D * (3 * B * Lq + 2 * sum(kl) + 2 * B * Lk) + 8 * B * Hl * Lq, peaks)
    return fwd, bwd


def tp_ce(torch, F, loss, timer, peaks, gen, size):
    """The fused CE on each rank's vocabulary rows (``ceil(V / size)``, the
    last fewer) with targets shifted to them, against the plain version per
    rank (a target outside the shard: logit 0), and merged (lse by max and
    sum, tgt summed, dh summed, dE concatenated) against the unsharded
    kernel. Returns (forward record, backward record); the timings are rank
    0's shard."""
    from pixparse_tpu_torch.parallel.tensor_parallel import TPLayout

    name, T, V, D, ignored = TP_CE
    dt = torch.bfloat16
    h = (torch.randn(T, D, generator=gen) * 0.5).to("cuda", dt)
    e = (torch.randn(V, D, generator=gen) * 0.2).to("cuda", dt)
    target = torch.randint(0, V, (T,), generator=gen)
    target[torch.rand(T, generator=gen) < ignored] = -1
    target = target.cuda()
    n_valid = int((target >= 0).sum())
    coef = torch.where(target >= 0, 1.0 / max(n_valid, 1), 0.0).float()
    lse, tgt = loss.fused_ce_fwd(h, e, target)
    dh, de = loss.fused_ce_bwd(h, e, target, lse, coef)
    layout = TPLayout(0, V)
    shards, fwd_errs, ok_f, outside_zero = [], [], True, True
    for r in range(size):
        off, e_r = layout.offset(r, size), layout.take(e, r, size)
        t_r = loss.shard_targets(target, off)
        lse_r, tgt_r = loss.fused_ce_fwd(h, e_r, t_r)
        lse_ref, tgt_ref = loss.fused_ce_fwd_plain(h, e_r, t_r)
        e1, k1 = close(lse_r, lse_ref, *LSE_TOL)
        e2, k2 = close(tgt_r, tgt_ref, *LSE_TOL)
        outside = (t_r < 0) | (t_r >= e_r.shape[0])
        outside_zero = outside_zero and bool((tgt_r[outside] == 0).all())
        fwd_errs.append(max(e1, e2))
        ok_f = ok_f and k1 and k2
        shards.append((off, e_r, t_r, lse_r, tgt_r))
        del lse_ref, tgt_ref
    m_lse, m_tgt = loss.merge_vocab_shards(torch.stack([s[3] for s in shards]),
                                           torch.stack([s[4] for s in shards]))
    c1, ok_c1 = close(m_lse, lse, *LSE_TOL)
    c2, ok_c2 = close(m_tgt, tgt, *LSE_TOL)
    bwd_errs, ok_b, dhs, des = [], True, [], []
    for off, e_r, t_r, _, _ in shards:
        dh_r, de_r = loss.fused_ce_bwd(h, e_r, t_r, m_lse, coef)
        dh_ref, de_ref = loss.fused_ce_bwd_plain(h, e_r, t_r, m_lse, coef)
        a, b = rows_close(dh_r, dh_ref, CE_ROW_RTOL), rows_close(de_r, de_ref, CE_ROW_RTOL)
        bwd_errs.append(max(a[0], b[0]))
        ok_b = ok_b and a[2] and b[2]
        dhs.append(dh_r.float())
        des.append(de_r)
        del dh_ref, de_ref
    cdh = rows_close(torch.stack(dhs).sum(0), dh, CE_ROW_RTOL)
    cde = rows_close(torch.cat(des), de, CE_ROW_RTOL)
    rows = [s[1].shape[0] for s in shards]
    common = dict(case=name, model=size, full_shape=[T, V, D], shard_rows=rows,
                  offsets=[s[0] for s in shards], dtype=str(dt), n_valid=n_valid)
    fwd = dict(common, max_abs_err=max(fwd_errs), rank_max_abs_err=fwd_errs,
               combined_max_abs_err=max(c1, c2), outside_target_logit_zero=outside_zero,
               tol=list(LSE_TOL), ok=ok_f and ok_c1 and ok_c2 and outside_zero)
    bwd = dict(common, max_abs_err=max(bwd_errs), rank_max_abs_err=bwd_errs,
               combined_max_abs_err=max(cdh[0], cde[0]),
               combined_worst_row_rel_err=max(cdh[1], cde[1]), tol=["row L2", CE_ROW_RTOL],
               ok=ok_b and cdh[2] and cde[2])
    off, e_r, t_r, _, _ = shards[0]
    Vr, elt = e_r.shape[0], 2
    lib = lambda: torch.logsumexp(F.linear(h, e_r).float(), -1)  # the shard's lse
    tp_timing(torch, timer, fwd, lambda: loss.fused_ce_fwd(h, e_r, t_r),
              lambda: loss.fused_ce_fwd_plain(h, e_r, t_r), lib, 2.0 * T * Vr * D,
              elt * D * (T + Vr) + 12 * T, peaks)
    hl, el = h.detach().requires_grad_(), e_r.detach().requires_grad_()
    lib_loss = (torch.logsumexp(F.linear(hl, el).float(), -1) * coef).sum()
    tp_timing(torch, timer, bwd, lambda: loss.fused_ce_bwd(h, e_r, t_r, m_lse, coef),
              lambda: loss.fused_ce_bwd_plain(h, e_r, t_r, m_lse, coef),
              lambda: torch.autograd.grad(lib_loss, (hl, el), retain_graph=True),
              6.0 * T * Vr * D, 2 * elt * D * (T + Vr) + 12 * T, peaks)
    return fwd, bwd


def tp_window(torch, F, wa, timer, peaks, gen, stage, size):
    """Window attention forward and backward at donut_base's stage
    ``stage`` (B=2, 2560x1920, shifted) on each rank's heads (its own
    fused q/k/v columns and bias rows), against the plain version per rank
    and, concatenated (dbias by heads), against the unsharded kernel.
    Returns (forward record, backward record); the timings are rank 0's
    shard."""
    from pixparse_tpu_torch.models.swin import _shift_attn_mask

    C, H = TP_WINDOW_STAGES[stage]
    n_img, window = 2, 10
    mh, mw = 640 >> stage, 480 >> stage
    N, nW = window * window, (mh // window) * (mw // window)
    nB, Cl, Hl = n_img * nW, C // size, H // size
    dt = torch.bfloat16
    qkv = torch.randn(nB, N, 3 * C, generator=gen).to("cuda", dt)
    q, k, v = qkv.split(C, dim=-1)
    do = torch.randn(nB, N, C, generator=gen).to("cuda", dt)
    bias = (torch.randn(H, N, N, generator=gen) * 0.5).cuda()
    mask = torch.from_numpy(_shift_attn_mask(mh, mw, window, window // 2)).cuda()
    o = wa.window_attention(q, k, v, bias, mask)
    grads = wa.window_attention_bwd(q, k, v, do, bias, mask)
    atol, rtol = TOL["bfloat16"]
    brtol = BWD_ROW_RTOL["bfloat16"]
    heads = lambda t, h: t.reshape(nB, N, h, -1)
    shards, fwd_errs, bwd_errs, ok_f, ok_b = [], [], [], True, True
    for r in range(size):
        cs, hs = slice(r * Cl, (r + 1) * Cl), slice(r * Hl, (r + 1) * Hl)
        qkv_r = torch.cat([q[..., cs], k[..., cs], v[..., cs]], -1).contiguous()
        qr, kr, vr = qkv_r.split(Cl, dim=-1)
        args = (qr, kr, vr, do[..., cs].contiguous(), bias[hs].contiguous(), mask)
        o_r = wa.window_attention(qr, kr, vr, args[4], mask)
        e_o, k_o = close(o_r, wa.window_attention_plain(qr, kr, vr, args[4], mask), atol, rtol)
        fwd_errs.append(e_o)
        ok_f = ok_f and k_o
        g_r = wa.window_attention_bwd(*args)
        g_ref = wa.window_attention_bwd_plain(*args)
        errs = [rows_close(heads(a, Hl) if i < 3 else a, heads(b, Hl) if i < 3 else b, brtol,
                           BWD_ROW_FLOOR) for i, (a, b) in enumerate(zip(g_r, g_ref))]
        bwd_errs.append(max(e[0] for e in errs))
        ok_b = ok_b and all(e[2] for e in errs)
        shards.append((o_r, g_r, args))
        del g_ref
    comb_o, ok_co = close(torch.cat([s[0] for s in shards], -1), o, *TP_COMBINED_TOL)
    comb_g = [rows_close(heads(torch.cat([s[1][i] for s in shards], -1), H), heads(grads[i], H),
                         brtol, BWD_ROW_FLOOR) for i in range(3)]
    comb_g.append(rows_close(torch.cat([s[1][3] for s in shards], 0), grads[3], brtol,
                             BWD_ROW_FLOOR))
    name = f"stage{stage}_b2_n100_c{C}_h{H}_shifted"
    common = dict(case=name, model=size, full_shape=[nB, N, C, H], shard_shape=[nB, N, Cl, Hl],
                  mask_period=nW, dtype=str(dt))
    fwd = dict(common, max_abs_err=max(fwd_errs), rank_max_abs_err=fwd_errs,
               combined_max_abs_err=comb_o, tol=[atol, rtol], ok=ok_f and ok_co)
    bwd = dict(common, max_abs_err=max(bwd_errs), rank_max_abs_err=bwd_errs,
               combined_max_abs_err=max(g[0] for g in comb_g),
               tol=["row L2", brtol, "floor", BWD_ROW_FLOOR],
               ok=ok_b and all(g[2] for g in comb_g))
    qr, kr, vr, dor, br, _ = shards[0][2]
    split = lambda t: t.reshape(nB, N, Hl, Cl // Hl).transpose(1, 2)
    am = (br[None] + mask.repeat(n_img, 1, 1)[:, None]).to(dt)
    lib = lambda: F.scaled_dot_product_attention(split(qr), split(kr), split(vr), attn_mask=am)
    elt = 2
    tp_timing(torch, timer, fwd, lambda: wa.window_attention(qr, kr, vr, br, mask),
              lambda: wa.window_attention_plain(qr, kr, vr, br, mask), lib,
              4.0 * nB * N * N * Cl, 4 * elt * nB * N * Cl + 4 * Hl * N * N + 4 * nW * N * N,
              peaks)
    leaves = [t.detach().requires_grad_() for t in (qr, kr, vr)]
    out = F.scaled_dot_product_attention(*(split(t) for t in leaves), attn_mask=am)
    args = shards[0][2]
    tp_timing(torch, timer, bwd, lambda: wa.window_attention_bwd(*args),
              lambda: wa.window_attention_bwd_plain(*args),
              lambda: torch.autograd.grad(out, leaves, split(dor), retain_graph=True),
              10.0 * nB * N * N * Cl, 7 * elt * nB * N * Cl + 8 * Hl * N * N + 4 * nW * N * N,
              peaks)
    return fwd, bwd


def tp_decode(torch, F, da, timer, peaks, gen, case, size):
    """The decode kernel (#8) on each rank's heads of the same full caches
    (each rank's own contiguous ``(B, Lk, H*D / size)`` buffers, as a cut
    decoder allocates them), against the plain version per rank and, heads
    concatenated, against the unsharded kernel (within the plain
    tolerance: ``decode_plan`` picks the tile and key split from the row
    width, so the merge order differs). Returns the record; the timings
    are rank 0's shard."""
    name, B, Lk, n_valid, H, D = case
    dt = torch.bfloat16
    Hl, HD = H // size, H * D
    q = torch.randn(B, 1, HD, generator=gen).to("cuda", dt)
    k = torch.randn(B, Lk, HD, generator=gen).to("cuda", dt)
    v = torch.randn(B, Lk, HD, generator=gen).to("cuda", dt)
    mask = (torch.arange(Lk) < n_valid)[None].expand(B, Lk).contiguous().cuda()
    o = da.decode_attention(q, k, v, mask, num_heads=H)
    atol, rtol = TOL["bfloat16"]
    errs, outs, ok = [], [], True
    for r in range(size):
        cols = slice(r * Hl * D, (r + 1) * Hl * D)
        qr, kr, vr = (t[..., cols].contiguous() for t in (q, k, v))
        o_r = da.decode_attention(qr, kr, vr, mask, num_heads=Hl)
        err, good = close(o_r, da.decode_attention_plain(qr, kr, vr, mask, num_heads=Hl),
                          atol, rtol)
        errs.append(err)
        ok = ok and good
        outs.append((o_r, qr, kr, vr))
    comb, ok_c = close(torch.cat([x[0] for x in outs], -1), o, atol, rtol)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rec = dict(case=name, model=size, full_shape=[B, Lk, H, D], shard_shape=[B, Lk, Hl, D],
               dtype=str(dt), valid_keys=int(mask.sum()), max_abs_err=max(errs),
               rank_max_abs_err=errs, combined_max_abs_err=comb, tol=[atol, rtol],
               plan_kt_split_keys_n_split=list(da.decode_plan(B, Lk, Hl * D * 2, n_sm)),
               ok=ok and ok_c)
    _, qr, kr, vr = outs[0]
    nvk, elt = int(mask.sum()), 2
    split = lambda t, n: t.view(B, n, Hl, D).transpose(1, 2)
    am = mask[:, None, None, :]
    tp_timing(torch, timer, rec, lambda: da.decode_attention(qr, kr, vr, mask, num_heads=Hl),
              lambda: da.decode_attention_plain(qr, kr, vr, mask, num_heads=Hl),
              lambda: F.scaled_dot_product_attention(split(qr, 1), split(kr, Lk), split(vr, Lk),
                                                     attn_mask=am),
              4.0 * D * Hl * nvk, elt * (2 * B * Hl * D + 2 * nvk * Hl * D) + B * Lk, peaks)
    rec["device_ms"] = timer.median_ms(
        lambda: da.decode_attention(qr, kr, vr, mask, num_heads=Hl), busy=True)
    return rec


def tp_kernel_cases(torch, F, card_name, timer):
    """(a): every kernel of the model-parallel train step and decode at the
    shard shapes of model 2 and 4. Returns ``{kernel: [records]}``; a
    mismatch fails the phase."""
    from pixparse_tpu_torch.ops import decode_attention as da
    from pixparse_tpu_torch.ops import flash_attention as fa
    from pixparse_tpu_torch.ops import loss
    from pixparse_tpu_torch.ops import window_attention as wa

    peaks = peaks_for(card_name)
    gen = torch.Generator().manual_seed(20)
    out = {k: [] for k in ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd",
                           "fused_ce_bwd", "window_attention", "window_attention_bwd",
                           "decode_attention")}

    def add(fwd_name, bwd_name, pair):
        for kernel, rec in zip((fwd_name, bwd_name), pair):
            out[kernel].append(rec)
            note({"phase": "tensor_parallel", "kernel": kernel, **rec})
        torch.cuda.empty_cache()

    for size in TP_SIZES:
        for case in tp_flash_cases():
            add("flash_attention_fwd", "flash_attention_bwd",
                tp_flash(torch, F, fa, timer, peaks, gen, case, size))
        for case in TP_DECODE_CASES:
            rec = tp_decode(torch, F, da, timer, peaks, gen, case, size)
            out["decode_attention"].append(rec)
            note({"phase": "tensor_parallel", "kernel": "decode_attention", **rec})
        add("fused_ce_fwd", "fused_ce_bwd", tp_ce(torch, F, loss, timer, peaks, gen, size))
        for stage in range(len(TP_WINDOW_STAGES)):
            add("window_attention", "window_attention_bwd",
                tp_window(torch, F, wa, timer, peaks, gen, stage, size))
    return out


def phase_tensor_parallel(torch, F=None, card_name=None, timer=None, model_name="cruller_base",
                          B=TP_B, steps=TP_STEPS, vocab=BART_VOCAB, device="cuda",
                          decode_B=TP_DECODE_B, new_tokens=TP_DECODE_NEW_TOKENS,
                          p2s_model="pix2struct_base", p2s_B=TP_P2S_B, p2s_steps=TP_P2S_STEPS):
    """(a) on the card: :func:`tp_kernel_cases`. (b) a child started by
    ``torch.distributed.run --nproc_per_node 2`` whose two ranks share the
    one device (gloo carries their collectives, CUDA tensors included;
    NCCL refuses two ranks on one device): :func:`tp_child` trains
    ``cruller_pretrain`` at ``model_name`` and ``pix2struct_pretrain`` at
    ``p2s_model``, then decodes ``model_name`` through the eval task, each
    at mesh (1,1,2) beside the process alone. Returns the model-parallel
    runs' launch counts, summed over the runs and the ranks."""
    rec = {"phase": "tensor_parallel", "model_name": model_name, "batch": B, "steps": steps,
           "problems": []}
    if device == "cuda":
        cases = tp_kernel_cases(torch, F, card_name, timer)
        rec["kernels"] = cases
        rec["problems"] += [f"{k}/{r['case']}/model={r['model']}" for k, recs in cases.items()
                            for r in recs if not r["ok"]]
    out = os.path.abspath(os.path.join(OUT_DIR, "tensor_parallel.json"))
    log_path = os.path.abspath(os.path.join(OUT_DIR, "tensor_parallel_child.log"))
    if os.path.exists(out):
        os.remove(out)
    spec = {"model_name": model_name, "B": B, "steps": steps, "vocab": vocab, "device": device,
            "decode_B": decode_B, "new_tokens": new_tokens, "p2s_model": p2s_model,
            "p2s_B": p2s_B, "p2s_steps": p2s_steps,
            "out": out, "out_dir": os.path.abspath(OUT_DIR)}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = str(CPU_CHILD_THREADS)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the child's ranks share the card
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           os.path.abspath(__file__), "--tp-child", json.dumps(spec)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here,
                                start_new_session=True)
        try:
            proc.wait(timeout=TP_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise SystemExit(f"tensor_parallel: the torchrun child ran past {TP_CHILD_TIMEOUT_S} "
                             f"s and was killed (its log: {log_path})")
    with open(log_path) as fh:
        tail = fh.read()[-4000:]
    if proc.returncode != 0 or not os.path.exists(out):
        print(tail, file=sys.stderr)
        raise SystemExit(f"tensor_parallel: the torchrun child exited {proc.returncode} "
                         f"(its log: {log_path})")
    with open(out) as fh:
        child = json.load(fh)
    child["wall_s"] = time.perf_counter() - t0
    rec["two_rank_step"] = child
    rec["problems"] += child["problems"]
    emit(rec)
    if rec["problems"]:
        raise SystemExit("tensor_parallel failed: " + "; ".join(rec["problems"]))
    counts = [*child["runs"]["model_parallel"]["launches_by_rank"],
              *child["pix2struct"]["runs"]["model_parallel"]["launches_by_rank"]]
    for by_part in child["decode"]["model_parallel"]["launches_by_rank"]:
        counts += [by_part["encode"], by_part["generate"]]
    return {"tensor_parallel": {k: sum(c[k] for c in counts) for k in counts[0]}}


def tp_child(spec) -> int:
    """One of the two ranks of (b): a gloo process group over both (on the
    card both take ``cuda:0``), ``MeshEnv.initialize`` at (1,1,2), then
    :func:`tp_runs`. Rank 0 writes the record to ``spec['out']``; exits 1
    when a check failed."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pixparse_tpu_torch.parallel.mesh import PROCESS_GROUP_TIMEOUT, MeshEnv

    global OUT_DIR
    OUT_DIR = spec["out_dir"]
    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(CPU_CHILD_THREADS)
    dist.init_process_group("gloo", timeout=PROCESS_GROUP_TIMEOUT)
    env = MeshEnv.initialize(data=1, fsdp=1, model=2, device=spec["device"])
    try:
        with nan_default_init(torch):
            rec = tp_runs(torch, env, spec)
    finally:
        env.close()
    if rec is not None:
        with open(spec["out"], "w") as fh:
            json.dump(rec, fh)
        return 1 if rec["problems"] else 0
    return 0


def tp_train_runs(torch, env, spec, task_name, cfg, make_sample, steps):
    """``task_name`` built from ``cfg`` by ``TaskFactory``, dropout 0, from
    one seed and one sample (``make_sample(task)``, as a loader hands it
    over): on rank 0 alone as a process alone (rank 1 waits), then on both
    ranks at mesh (1,1,2), ``steps`` steps each through the task's
    ``train_step``, the counts zeroed before each run and read after it.
    Returns ``{"alone": run, "model_parallel": run}`` (rank 1: no
    ``"alone"``)."""
    import gc

    import torch.distributed as dist

    from pixparse_tpu_torch.parallel.mesh import MeshEnv
    from pixparse_tpu_torch.task.task_factory import TaskFactory

    on_card = spec["device"] == "cuda"
    runs = {}
    for tag, task_env in (("alone", MeshEnv(device=env.device)), ("model_parallel", env)):
        if tag == "alone" and env.global_rank != 0:
            dist.barrier()  # rank 0's run alone
            continue
        task, _ = TaskFactory.create_task(task_name, cfg, task_env, monitor=None)
        # dropout 0: a model rank draws its FFN masks at the shard's shape,
        # so no mask could equal the process alone's
        task.bart_cfg = dataclasses.replace(
            task.bart_cfg, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
        sample = make_sample(task)
        task.train_setup(num_batches_per_interval=steps, seed=0)
        step_fn, seen = task.train_step_fn, []

        def recording(state, batch, step_fn=step_fn, seen=seen):
            state, metrics = step_fn(state, batch)
            seen.append(metrics)
            return state, metrics

        task.train_step_fn = recording
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync(torch)
        reset_counts()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            task.train_step(sample)
            float(task._last_loss_dev)
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        run = {"losses": [float(m["loss"]) for m in seen],
               "grad_norms": [float(m["grad_norm"]) for m in seen],
               "ms_by_step": ms, "peak_mem_bytes":
                   torch.cuda.max_memory_allocated() if on_card else None,
               "split_params": len(task.state.tp_layouts)}
        if tag == "model_parallel":
            run["launches_by_rank"] = env.all_gather_object(launches)
            run["losses_by_rank"] = env.all_gather_object(run["losses"])
        else:
            run["launches"] = launches
        runs[tag] = run
        del task, recording, step_fn, sample
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        if tag == "alone":
            dist.barrier()
    return runs


def tp_train_checks(runs, steps, kernels, on_card, tag=""):
    """``(step-1 record, problems)`` of :func:`tp_train_runs`' runs: finite
    losses, the same on both ranks, parameters split only at model 2, the
    step-1 loss (``DIST_LOSS_RTOL``) and gradient norm (``DIST_NORM_RTOL``)
    against the process alone, ``kernels``' launches a step on each rank
    equal to the process alone's (and, on the card, launched)."""
    import numpy as np

    problems = []
    alone, mp = runs["alone"], runs["model_parallel"]
    for run_tag, run in runs.items():
        if not all(np.isfinite(run["losses"])):
            problems.append(f"{tag}{run_tag}: losses not finite: {run['losses']}")
    if mp["losses_by_rank"][0] != mp["losses_by_rank"][1]:
        problems.append(f"{tag}the ranks' losses differ: {mp['losses_by_rank']}")
    if mp["split_params"] == 0 or alone["split_params"] != 0:
        problems.append(f"{tag}split parameters: model-parallel {mp['split_params']}, alone "
                        f"{alone['split_params']}")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    step1 = {"loss_rel": rel(mp["losses"][0], alone["losses"][0]),
             "grad_norm_rel": rel(mp["grad_norms"][0], alone["grad_norms"][0])}
    if not step1["loss_rel"] <= DIST_LOSS_RTOL:
        problems.append(f"{tag}step-1 loss: model-parallel {mp['losses'][0]} vs alone "
                        f"{alone['losses'][0]}")
    if not step1["grad_norm_rel"] <= DIST_NORM_RTOL:
        problems.append(f"{tag}step-1 grad norm: model-parallel {mp['grad_norms'][0]} vs alone "
                        f"{alone['grad_norms'][0]}")
    for r, launches in enumerate(mp["launches_by_rank"]):
        per_step = {k: launches[k] / steps for k in kernels}
        if per_step != {k: alone["launches"][k] / steps for k in kernels}:
            problems.append(f"{tag}rank {r}'s launches a step {per_step} differ from the "
                            f"process alone's")
        if on_card and not all(n > 0 for n in per_step.values()):
            problems.append(f"{tag}rank {r} never launched some kernels: {per_step}")
    return step1, problems


def forced_logits(torch, model, enc, tokens, pad):
    """The logits of ``generate``'s prefill and steps, teacher-forced along
    ``tokens`` ``(B, L)`` (a one-token prompt, then the tokens as given):
    ``(B, L - 1, V)`` fp32, on the CPU."""
    from pixparse_tpu_torch.models.bart import KVCache

    B, L = tokens.shape
    buffer = torch.full_like(tokens, pad)
    buffer[:, 0] = tokens[:, 0]
    cache = KVCache(max_len=L)
    with torch.inference_mode():
        out = [model.decode(tokens[:, :1], enc, cache, key_pad_mask=buffer != pad,
                            mode="prefill")[:, -1].cpu()]
        for cur in range(1, L - 1):
            buffer[:, cur] = tokens[:, cur]
            out.append(model.decode(tokens[:, cur:cur + 1], enc, cache,
                                    key_pad_mask=buffer != pad, mode="decode",
                                    positions=torch.full((B, 1), cur, device=tokens.device)
                                    )[:, -1].cpu())
    return torch.stack(out, 1)


def tp_decode_runs(torch, env, spec, tok_dir):
    """(b) decoding: the registered ``cruller_eval_ocr`` task at
    ``spec['model_name']``, bf16, seed-0 weights (its ``setup``: at mesh
    (1,1,2) the model cut over ``model``), ``decode_B`` seeded pages, the
    task's one-token prompt, ``new_tokens`` greedy tokens through
    ``generate`` with EOS off: on rank 0 alone (rank 1 waits), then on both
    ranks; the counts zeroed before each encode and each ``generate`` and
    read after it. Then both ranks' logits teacher-forced along alone's
    tokens. Returns ``(record, problems)`` on rank 0, ``(None, [])`` on
    rank 1."""
    import numpy as np
    import torch.distributed as dist

    from pixparse_tpu_torch.parallel.mesh import MeshEnv
    from pixparse_tpu_torch.task.task_cruller_eval_ocr import TaskCrullerEvalOCRCfg
    from pixparse_tpu_torch.task.task_factory import TaskFactory
    from pixparse_tpu_torch.ops.generation import generate
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    device, B, new_tokens = spec["device"], spec["decode_B"], spec["new_tokens"]
    on_card, rank = device == "cuda", env.global_rank
    cfg = TaskCrullerEvalOCRCfg(model_name=spec["model_name"], tokenizer=TokenizerCfg(name=tok_dir),
                                dtype="bfloat16", device=device)
    runs, alone_tokens = {}, None
    for tag, task_env in (("alone", MeshEnv(device=env.device)), ("model_parallel", env)):
        if tag == "alone" and rank != 0:
            dist.barrier()
            continue
        task, _ = TaskFactory.create_task("cruller_eval_ocr", cfg, task_env)
        task.setup()
        h, w = task.vit_cfg.img_size
        images = synthetic_pages(torch, B, h, w, torch.Generator().manual_seed(3)).numpy()
        prompt = torch.as_tensor(task.prompt_ids(task.task_start_token, B), device=env.device)
        pad = task.tokenizer.pad_token_id
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync(torch)
        reset_counts()
        t0 = time.perf_counter()
        enc = task.encode_images(images)
        sync(torch)
        encode_ms = (time.perf_counter() - t0) * 1e3
        encode_launches = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        result = generate(task.model, enc, prompt, max_length=prompt.shape[1] + new_tokens,
                          eos_token_id=-1, pad_token_id=pad)
        sync(torch)
        generate_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        tokens = result.tokens
        if tag == "alone":
            alone_tokens = tokens.cpu()
        else:  # rank 1 takes alone's tokens from rank 0
            alone_tokens = env.broadcast_object(alone_tokens)
        logits = forced_logits(torch, task.model, enc, alone_tokens.to(env.device), pad)
        run = {"encode_ms": encode_ms, "generate_ms": generate_ms, "steps": result.steps,
               "decode_ms_per_step": generate_ms / (result.steps + 1),
               "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
               "split_params": len(getattr(task.model, "tp_layouts", {})),
               "encode_launches": encode_launches, "generate_launches": launches,
               "decoder_layers": task.bart_cfg.decoder_layers,
               "encoder_depth": task.vit_cfg.depth, "vocab": task.vocab_size}
        if tag == "model_parallel":
            run["tokens_by_rank"] = env.all_gather_object(tokens.cpu().numpy())
            run["launches_by_rank"] = env.all_gather_object(
                {"encode": encode_launches, "generate": launches})
        runs[tag] = (run, tokens.cpu(), logits)
        del task, enc, result
        if on_card:
            torch.cuda.empty_cache()
        if tag == "alone":
            dist.barrier()
    if rank != 0:
        return None, []
    (alone, a_tokens, a_logits), (mp, _, mp_logits) = runs["alone"], runs["model_parallel"]
    problems = []
    ranks = mp.pop("tokens_by_rank")
    ranks_equal = all(np.array_equal(t, ranks[0]) for t in ranks)
    if not ranks_equal:
        problems.append("decode: the ranks' tokens differ")
    gen_cols = slice(1, None)
    share = float((torch.from_numpy(ranks[0])[:, gen_cols] == a_tokens[:, gen_cols])
                  .float().mean())
    prefill_err, prefill_ok = close(mp_logits[:, 0], a_logits[:, 0], TP_DECODE_GATE,
                                    TP_DECODE_GATE)
    step_errs = [close(mp_logits[:, i], a_logits[:, i], TP_DECODE_GATE, TP_DECODE_GATE)
                 for i in range(1, a_logits.shape[1])]
    if not prefill_ok:
        problems.append(f"decode: prefill logits {prefill_err} off alone's")
    if not all(ok for _, ok in step_errs):
        problems.append(f"decode: teacher-forced logits off alone's at steps "
                        f"{[i + 1 for i, (_, ok) in enumerate(step_errs) if not ok]}")
    if mp["split_params"] == 0 or alone["split_params"] != 0:
        problems.append(f"decode: split parameters: model-parallel {mp['split_params']}, alone "
                        f"{alone['split_params']}")
    steps = alone["steps"]
    for r, counts in enumerate(mp["launches_by_rank"]):
        for part in ("encode", "generate"):
            mine = {k: counts[part][k] for k in TP_DECODE_KERNELS}
            want = {k: alone[f"{part}_launches"][k] for k in TP_DECODE_KERNELS}
            if mine != want:
                problems.append(f"decode: rank {r}'s {part} launches {mine} differ from the "
                                f"process alone's {want}")
        if on_card and not (counts["encode"]["flash_attention_fwd"] > 0
                            and counts["generate"]["decode_attention"] > 0):
            problems.append(f"decode: rank {r} never launched #1/#2 or #8: {counts}")
    rec = {"batch": B, "new_tokens": new_tokens, "steps": steps, "gate": TP_DECODE_GATE,
           "tokens_equal_across_ranks": ranks_equal,
           "share_equal_to_alone": share, "prefill_max_abs_err": prefill_err,
           "teacher_forced_max_abs_err": max(e for e, _ in step_errs),
           "decode_launches_a_step_by_rank": [
               c["generate"]["decode_attention"] / max(steps, 1) for c in mp["launches_by_rank"]],
           "flash_launches_an_encode_by_rank": [
               c["encode"]["flash_attention_fwd"] for c in mp["launches_by_rank"]],
           "alone": alone, "model_parallel": mp}
    return rec, problems


def tp_runs(torch, env, spec):
    """(b) on both ranks: ``cruller_pretrain`` as ``train_task`` builds it
    and ``pix2struct_pretrain`` at ``spec['p2s_model']`` (the pix2struct
    phase's pages), each on rank 0 alone and at mesh (1,1,2)
    (:func:`tp_train_runs`), then decoding (:func:`tp_decode_runs`). Rank 0
    returns the record (None on rank 1)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_cruller_pretrain import TaskCrullerPretrainCfg
    from pixparse_tpu_torch.task.task_pix2struct_pretrain import TaskPix2StructPretrainCfg
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    model_name, B, steps, vocab, device = (spec[k] for k in ("model_name", "B", "steps", "vocab",
                                                             "device"))
    on_card = device == "cuda"
    rank = env.global_rank
    rec = {"backend": dist.get_backend(), "world_size": dist.get_world_size(), "env": str(env),
           "task": "cruller_pretrain", "model_name": model_name, "batch": B, "steps": steps,
           "vocab": vocab, "dtype": "bfloat16", "runs": {}, "problems": []}
    problems = rec["problems"]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_tp{rank}_")
    try:
        tok_dir = saved_tokenizer(os.path.join(tmp, f"tokenizer{vocab}"), vocab)
        opt = OptimizationCfg(learning_rate=3e-4)
        cfg = TaskCrullerPretrainCfg(
            model_name=model_name, tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
            device=device, num_intervals=2, num_warmup_intervals=0, opt=opt)

        def cruller_sample(task):
            enc = task.vit_cfg
            return SeededLoader(torch, 1, B, enc.img_size, task.max_position_embeddings, seed=0,
                                in_chans=enc.in_chans, vocab=vocab).batches[0]

        rec["runs"] = tp_train_runs(torch, env, spec, "cruller_pretrain", cfg, cruller_sample,
                                    steps)
        p2s_cfg = TaskPix2StructPretrainCfg(
            model_name=spec["p2s_model"], tokenizer=TokenizerCfg(name=tok_dir), dtype="bfloat16",
            device=device, num_intervals=2, num_warmup_intervals=0, opt=opt)

        def p2s_sample(task):
            gen = torch.Generator().manual_seed(0)
            enc = task.vit_cfg
            image = pix2struct_batch(torch, spec["p2s_B"], PIX2STRUCT_PAGES, enc.max_patches,
                                     enc.patch_size, gen, device)
            text, target = synthetic_tokens(torch, spec["p2s_B"], task.max_position_embeddings,
                                            vocab, gen)
            return ({k: v.cpu().numpy() for k, v in image.items()}, text.numpy(), target.numpy())

        p2s_runs = tp_train_runs(torch, env, spec, "pix2struct_pretrain", p2s_cfg, p2s_sample,
                                 spec["p2s_steps"])
        decode, decode_problems = tp_decode_runs(torch, env, spec, tok_dir)
        if rank != 0:
            return None
        rec["step1"], found = tp_train_checks(rec["runs"], steps, DIST_STEP_KERNELS, on_card)
        problems += found
        p2s_step1, found = tp_train_checks(p2s_runs, spec["p2s_steps"], TP_P2S_KERNELS, on_card,
                                           "pix2struct: ")
        problems += found + decode_problems
        rec["pix2struct"] = {"model_name": spec["p2s_model"], "batch": spec["p2s_B"],
                             "steps": spec["p2s_steps"], "step1": p2s_step1, "runs": p2s_runs}
        rec["decode"] = decode
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="serve_model, serve_donut, train_model, train_donut, beam_eval, "
                         "large, pix2struct, distributed: also trace encode, generate and one train step with "
                         "torch.profiler (device time by kernel, device idle share)")
    ap.add_argument("--distributed-child", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--tp-child", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.distributed_child:  # one rank of the distributed phase's torchrun
        return distributed_child(json.loads(args.distributed_child))
    if args.tp_child:  # one rank of the tensor_parallel phase's torchrun
        return tp_child(json.loads(args.tp_child))
    t_main = time.perf_counter()
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
          "q8_ptxas": ptxas_summary(_build.ptxas_log("decode_attention_q8"), Q8_LN[:1]),
          "ln_bwd_ptxas": ptxas_summary(_build.ptxas_log("layer_norm"), Q8_LN[1:2]),
          "ln_fwd_ptxas": ptxas_summary(_build.ptxas_log("layer_norm"), Q8_LN[2:]),
          "window_ptxas": window_ptxas})

    timer = Timer(torch)
    results, path_launches = {}, {}
    prof = args.profile
    runs = {  # in PHASES order; each adds the launch counts of the paths it drives
        "kernels": lambda: results.update(phase_kernels(torch, F, smi, timer)),
        "probes": lambda: path_launches.update(probes=phase_probes(torch)),
        "serve_model": lambda: phase_serve_model(torch, profile=prof),
        "serve_task": lambda: path_launches.update(serve_task=phase_serve_task(torch)),
        "serve_donut": lambda: phase_serve_donut(torch, profile=prof),
        "eval_task": lambda: path_launches.update(phase_eval_task(torch)),
        "train_model": lambda: phase_train_model(torch, profile=prof),
        "train_donut": lambda: path_launches.update(phase_train_donut(torch, profile=prof)),
        "train_task": lambda: path_launches.update(phase_train_task(torch)),
        "pretrained_train": lambda: path_launches.update(phase_pretrained_train(torch)),
        "finetune_tasks": lambda: path_launches.update(phase_finetune_tasks(torch)),
        "beam_eval": lambda: path_launches.update(phase_beam_eval(torch, profile=prof)),
        "sample": lambda: path_launches.update(phase_sample(torch)),
        "naive": lambda: path_launches.update(phase_naive(torch)),
        "large": lambda: path_launches.update(phase_large(torch, profile=prof)),
        "pix2struct": lambda: path_launches.update(phase_pix2struct(torch, profile=prof)),
        "serve_stream": lambda: path_launches.update(phase_serve_stream(torch)),
        "loader": lambda: path_launches.update(phase_loader(torch)),
        "distributed": lambda: path_launches.update(phase_distributed(torch, profile=prof)),
        "tensor_parallel": lambda: path_launches.update(
            phase_tensor_parallel(torch, F, smi, timer)),
    }
    seconds = {"build": build_s}
    with nan_default_init(torch):
        for name, run in runs.items():
            if name in phases:
                t0 = time.perf_counter()
                run()
                seconds[name] = time.perf_counter() - t0
    emit({"phase": "seconds", **seconds, "main": time.perf_counter() - t_main})

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
                **{k: rec[k] for k in LINE_KEYS},
                # the probe kernels, #9, #12 and #13: busy-timer time and shares
                **({k: rec[k] for k in ("device_ms", "bound_share", "ratio_to_library")}
                   if name in PROBE_OWN_KERNELS + BUSY_TIMED else {}),
                # beam_eval's and large's shapes, each against the plain version
                **({"new_path_cases": [
                    {"case": r["case"], **{k: r[k] for k in LINE_KEYS}}
                    for r in results[name] if r["case"] in NEW_PATH_CASES[name]]}
                   if name in NEW_PATH_CASES else {}),
            })
        emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
