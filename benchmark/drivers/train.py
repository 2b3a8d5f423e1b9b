"""Traffic kind ``train``: the registered train task's ``train_step`` on
collated host batches in the task's input format (float32 pages,
unshifted text and target rows), cycled from a pool made from the seed.

Set-up builds the task once (tokenizer, model with the seeded weights, the
train state), runs its first steps through ``train_step`` on rows that all
differ and records what the comparison needs from them (each step's loss,
the first gradient from the Adam state after step 1, each leaf's change
after the last of them), warms up, and hands the same task to the window.
The window runs ``train_step`` until ``--seconds`` have passed and waits
for the card; the rate is the samples over all of that time. A traced run
then profiles ``trace_steps`` more steps. Once the window has closed and
the peak memory has been read, the program is freed and the reference runs
the first steps again from the same weights and batches.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from bench_lib import compare, tracing, traffic
from bench_lib.env import CACHE_DIR, process_start
from bench_lib.flops import train_step_flops
from bench_lib.program import make_task, read_counts
from bench_lib.record import RunRecord
from bench_lib.seeds import mix
from bench_lib.weights import seeded_weights

DROPOUT_SALT = 0xD50F_0002


def make_pool(cell, task, seed: int) -> List[Dict]:
    p, cfg = cell.params, cell.cfg
    H, W, C = traffic.image_shape(cfg)
    tok = task.tokenizer
    start_id = tok.encode(task.task_start_token, add_special_tokens=False)[0]
    pool = []
    for i in range(p["pool_batches"]):
        rng = traffic.rng_for(seed, i)
        text, target = traffic.pretrain_rows(
            rng, p["batch"], p["text_positions"], tuple(p["real_len"]),
            cfg["decoder"]["vocab_size"], p["first_token_id"], start_id, tok.eos_token_id,
            tok.pad_token_id)
        pool.append({"image": traffic.pages(rng, p["batch"], H, W, C),
                     "text": text, "target": target})
    return pool


def delta_norms(torch, params: Dict, start: Dict) -> Dict[str, float]:
    """Each leaf's change from ``start``, as its norm."""
    deltas = torch._foreach_norm([params[n].detach().float() - start[n] for n in params])
    return {n: float(v) for n, v in zip(params, deltas)}


def run(cell, args, torch, device: str = "cuda") -> RunRecord:
    p, cfg = cell.params, cell.cfg
    seed = args.seed
    weights = seeded_weights(torch, cfg, seed, device)
    task = make_task(cell, device, weights)
    del weights
    base_seed = mix(seed, DROPOUT_SALT) % (1 << 31)
    task.train_setup(num_batches_per_interval=p["batches_per_interval"], seed=base_seed)
    pool = make_pool(cell, task, seed)
    first_steps = p["first_steps"]
    if first_steps > len(pool):
        raise ValueError("the first steps need rows that all differ: pool_batches >= first_steps")
    b1 = (p["opt"].get("betas") or (0.9, 0.999))[0]

    losses = []
    for k in range(first_steps):
        losses.append(task.train_step(pool[k])["loss"])
        if k == 0:
            mu = task.state.opt_state["mu"]
            norms = torch._foreach_norm([mu[n].float() for n in task.state.params])
            grad_norms = {n: float(v) / (1.0 - b1) for n, v in zip(task.state.params, norms)}
    prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "delta_norms": delta_norms(torch, task.state.params,
                                       seeded_weights(torch, cfg, seed, device))}
    for k in range(p["warmup_steps"]):
        task.train_step(pool[(first_steps + k) % len(pool)])
    if device != "cpu":
        torch.cuda.synchronize(device)
    setup_s = time.time() - process_start()

    spans = tracing.Spans(torch, sync=False)
    at = first_steps + p["warmup_steps"]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats(device)
    steps = 0
    t0 = time.perf_counter()
    while True:
        with spans("train_step"):
            task.train_step(pool[at % len(pool)])
        at += 1
        steps += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    if device != "cpu":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device != "cpu" else 0

    trace, launches, traced_valid = None, None, []
    if args.trace:
        passes = []  # each profiled pass's valid targets a step

        def traced():
            nonlocal at
            valid = []
            for _ in range(p["trace_steps"]):
                batch = pool[at % len(pool)]
                with spans("train_step"):
                    task.train_step(batch)
                valid.append(int((batch["target"][:, 1:] != -100).sum()))
                at += 1
            passes.append(valid)

        trace = tracing.profile(torch, traced, f"{CACHE_DIR}/trace-{args.seed}", counts=read_counts)
        launches = trace["wrapper_launches"]
        traced_valid = passes[0]  # the device pass's

    text_len = p["text_positions"] - 1
    rec = RunRecord(
        cell=cell, seed=seed, setup_s=setup_s, memory_peak_bytes=peak,
        attempted=steps, failed=0, spans=spans, trace=trace, launches=launches,
        window={"seconds": window_s, "steps": steps, "samples": steps * p["batch"],
                "flops": steps * train_step_flops(cfg, p["batch"], text_len),
                "trace_steps": p["trace_steps"], "batch": p["batch"], "text_len": text_len,
                "trace_valid_targets": traced_valid},
    )
    rec.e2e = {"train_samples_per_s": steps * p["batch"] / window_s,
               "peak_memory_gib": peak / 2 ** 30, "setup_s": setup_s}

    del task
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_readings(torch, cell, seed, pool[:first_steps], base_seed, device, "fp32")
    rec.window["check_s"] = time.perf_counter() - t_check
    numbers = compare.train_numbers(prog, ref)
    rec.checks = compare.checks(numbers, cell.spec["check"]["limits"])
    rec.check_inputs = {"batches": pool[:first_steps], "base_seed": base_seed, "ref": ref,
                        "numbers": numbers}
    return rec


def control_numbers(torch, cell, rec, device: str = "cuda") -> Dict:
    """The control's numbers on the run's own inputs: the reference in fp8
    in the program's place."""
    ins = rec.check_inputs
    ctrl = reference_readings(torch, cell, rec.seed, ins["batches"], ins["base_seed"], device, "fp8")
    return compare.train_numbers(ctrl, ins["ref"])


def reference_readings(torch, cell, seed, batches, base_seed, device, numerics: str) -> Dict:
    """The reference's readings of the same first steps (``numerics``
    ``fp8``: the control)."""
    from reference.model import build
    from reference.numerics import Numerics, exact_matmuls
    from reference.train import train_readings

    p, cfg = cell.params, cell.cfg
    opt = dict(p["opt"], num_intervals=p["num_intervals"],
               num_warmup_intervals=p["num_warmup_intervals"],
               updates_per_interval=p["batches_per_interval"])
    with exact_matmuls():
        model = build(cfg, seeded_weights(torch, cfg, seed, device), device)
        out = train_readings(model, Numerics(numerics), batches, opt, base_seed + 1,
                             cell.spec["check"]["chunk_rows"], device)
    del model
    gc.collect()
    return out
