"""Traffic kind ``greedy_eval``: batches of pages through the registered
eval task's ``encode_images``, the program's KV-cached greedy
``ops.generation.generate`` with EOS disabled (every page decodes the
cell's ``new_tokens``), and the task tokenizer's ``batch_decode``: the path
of ``generate_text`` with a fixed budget. Batches are cycled from a pool
made from the seed.

The window runs whole batches until ``--seconds`` have passed; the rate is
the pages of the completed batches over the time from the window's start to
the end of its last batch. Of each pool batch's first pass the window keeps
the encoder rows and served tokens of the pages drawn for the check (the
longest prompt of the batch among them). Once the window has closed, the
peak memory has been read and the program is freed, the reference runs
each kept page whole, teacher-forced over its prompt and served tokens.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from bench_lib import compare, tracing, traffic
from bench_lib.env import CACHE_DIR, process_start
from bench_lib.flops import eval_batch_flops
from bench_lib.program import make_task, read_counts
from bench_lib.record import RunRecord
from bench_lib.weights import seeded_weights

CHECK_STREAM = 1 << 20  # traffic stream of the check's draw


def make_pool(cell, task, seed: int) -> List[Dict]:
    p, cfg = cell.params, cell.cfg
    H, W, C = traffic.image_shape(cfg)
    B = p["batch"]
    pool = []
    for i in range(p["pool_batches"]):
        rng = traffic.rng_for(seed, i)
        images = traffic.pages(rng, B, H, W, C)
        if p["prompt"] == "docvqa":
            prompts = task.batch_prompts(traffic.questions(rng, B, tuple(p["question_chars"])))
        else:
            prompts = task.prompt_ids(task.task_start_token, B)
        prompts = np.asarray(prompts, np.int64)
        real = (prompts != task.tokenizer.pad_token_id).sum(axis=1)
        # the check's pages: the longest prompt, then others drawn from the seed
        crng = traffic.rng_for(seed, CHECK_STREAM + i)
        others = [int(r) for r in crng.permutation(B) if r != int(np.argmax(real))]
        rows = [int(np.argmax(real))] + others[:p["check_rows_per_batch"] - 1]
        pool.append({"images": images, "prompts": prompts, "real": real, "rows": rows})
    return pool


class Batches:
    """One pool batch through the program: encode, decode, detokenize."""

    def __init__(self, torch, task, p: Dict, spans, device: str):
        from pixparse_tpu_torch.ops.generation import generate

        self.torch, self.task, self.p, self.spans, self.device = torch, task, p, spans, device
        self.generate = generate

    def __call__(self, batch: Dict):
        torch, task = self.torch, self.task
        prompts = batch["prompts"]
        with self.spans("encode"):
            enc = task.encode_images(batch["images"])
        with self.spans("generate"):
            with torch.inference_mode():
                res = self.generate(
                    task.model, enc, torch.as_tensor(prompts, device=self.device),
                    max_length=prompts.shape[1] + self.p["new_tokens"],
                    eos_token_id=-1, pad_token_id=task.tokenizer.pad_token_id)
            tokens = res.tokens.cpu().numpy()
        with self.spans("detokenize"):
            pad = task.tokenizer.pad_token
            texts = [t.replace(pad, "") for t in task.tokenizer.batch_decode(
                tokens.tolist(), skip_special_tokens=False)]
        return enc, res.steps, tokens, texts


def run(cell, args, torch, device: str = "cuda") -> RunRecord:
    p, cfg = cell.params, cell.cfg
    seed = args.seed
    task = make_task(cell, device, seeded_weights(torch, cfg, seed, device))
    task.setup()
    pool = make_pool(cell, task, seed)
    spans = tracing.Spans(torch, sync=bool(args.trace))
    run_batch = Batches(torch, task, p, spans, device)
    for k in range(p["warmup_batches"]):
        run_batch(pool[k % len(pool)])
    if device != "cpu":
        torch.cuda.synchronize(device)
    setup_s = time.time() - process_start()
    spans.records.clear()

    kept: Dict[int, Dict] = {}
    steps: List[int] = []
    flops = 0.0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats(device)
    at, pages = 0, 0
    ends: List[float] = []  # each batch's end, from the window's start
    t0 = time.perf_counter()
    while True:
        batch = pool[at % len(pool)]
        enc, n_steps, tokens, _ = run_batch(batch)
        ends.append(time.perf_counter() - t0)
        if at < len(pool):
            rows = batch["rows"]
            kept[at] = {"enc": enc[rows].float().cpu(), "tokens": tokens[rows]}
        del enc
        steps.append(n_steps)
        flops += eval_batch_flops(cfg, batch["real"], p["new_tokens"])
        pages += len(tokens)
        at += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device != "cpu" else 0

    trace, launches, traced_steps = None, None, []
    if args.trace:
        batch = pool[at % len(pool)]

        def traced():  # once in each of the profiler's two passes
            traced_steps.append(run_batch(batch)[1])

        trace = tracing.profile(torch, traced, f"{CACHE_DIR}/trace-{args.seed}", counts=read_counts)
        launches = trace["wrapper_launches"]
        trace["batch_real"] = [int(n) for n in batch["real"]]
        trace["batch_prompt_cols"] = int(batch["prompts"].shape[1])

    rec = RunRecord(
        cell=cell, seed=seed, setup_s=setup_s, memory_peak_bytes=peak,
        attempted=pages, failed=0, spans=spans, trace=trace, launches=launches,
        window={"seconds": window_s, "batches": len(steps), "pages": pages,
                "decode_steps": sum(steps), "flops": flops,
                "traced_steps": traced_steps[0] if traced_steps else None,
                "batch_s": [b - a for a, b in zip([0.0] + ends, ends)],
                "span_s": {n: [s for m, s in spans.records if m == n][:len(ends)]
                           for n in ("encode", "generate", "detokenize")}},
    )
    rec.e2e = {"eval_pages_per_s": pages / window_s, "peak_memory_gib": peak / 2 ** 30,
               "setup_s": setup_s}
    task.model = None
    del task, run_batch
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = reference_numbers(torch, cell, seed, pool, kept, device)
    rec.window["check_s"] = time.perf_counter() - t_check
    rec.checks = compare.checks(numbers, cell.spec["check"]["limits"])
    rec.check_inputs = {"pool": pool, "kept": kept, "numbers": numbers}
    return rec


def control_numbers(torch, cell, rec, device: str = "cuda") -> Dict:
    """The control's numbers on the pages and served tokens the run kept."""
    ins = rec.check_inputs
    return reference_numbers(torch, cell, rec.seed, ins["pool"], ins["kept"], device, "fp8")


def reference_numbers(torch, cell, seed, pool, kept, device, numerics: str = "fp32") -> Dict:
    """``enc_gap`` and ``served_gap`` of the kept pages; with ``numerics``
    ``fp8`` the control's: its own encoder rows, and at every position the
    gap of the token it puts first."""
    from reference.model import build, teacher_forced
    from reference.numerics import Numerics, exact_matmuls

    p, cfg = cell.params, cell.cfg
    new = p["new_tokens"]
    enc_gap, served_gap = 0.0, 0.0
    margins, distinct = [], []
    with exact_matmuls(), torch.no_grad():
        model = build(cfg, seeded_weights(torch, cfg, seed, device), device)
        exact, num = Numerics("fp32"), Numerics(numerics)
        for i, got in sorted(kept.items()):
            batch = pool[i]
            Lp = batch["prompts"].shape[1]
            for j, row in enumerate(batch["rows"]):
                prompt = batch["prompts"][row][:batch["real"][row]]
                served = got["tokens"][j][Lp:Lp + new]
                ids = torch.as_tensor(np.concatenate([prompt, served[:-1]])[None], device=device)
                image = torch.as_tensor(batch["images"][row:row + 1], device=device)
                enc_ref, logits = teacher_forced(model, exact, image, ids)
                logits = logits[0, len(prompt) - 1:]
                top2 = logits.topk(2, dim=-1).values
                best = top2[:, 0]
                margins.append(top2[:, 0] - top2[:, 1])
                distinct.append(len(set(served.tolist())) / len(served))
                if numerics == "fp32":
                    enc_prog = got["enc"][j].to(device)
                    pick = torch.as_tensor(served, device=device)
                else:
                    enc_prog, ctrl = teacher_forced(model, num, image, ids)
                    enc_prog = enc_prog[0]
                    pick = ctrl[0, len(prompt) - 1:].argmax(dim=-1)
                gap = best - logits.gather(1, pick[:, None])[:, 0]
                served_gap = max(served_gap, float(gap.max()))
                rel = (enc_prog - enc_ref[0]).norm() / enc_ref[0].norm()
                enc_gap = max(enc_gap, float(rel))
    del model
    gc.collect()
    # beside the two numbers: how flat the reference's top is at the served
    # positions, and how varied the served tokens are
    return {"enc_gap": enc_gap, "served_gap": served_gap,
            "median_top2_margin": float(torch.cat(margins).median()) if margins else None,
            "distinct_token_share": float(np.mean(distinct)) if distinct else None}
