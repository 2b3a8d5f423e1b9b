"""Traffic kind ``moe_train``: the ``train`` driver's contract for a model
whose decoder routes its tokens to experts (``cruller_moonlight``): the
registered train task's ``train_step`` on collated host batches in the
task's input format (float32 pages, unshifted text and target rows),
cycled from a pool made from the seed.

Set-up first makes sure the program has the configuration's model and
that its resolved sizes are the file's, before anything is built (a program
without it fails at once). Then the task (tokenizer, the model with the
seeded weights of :mod:`bench_lib.moe`, the train state); its first steps
on rows that all differ, recording what the comparison needs (each step's
loss, the first gradient from the Adam state after step 1, each leaf's
change after the last of them, and the router's choices and scores of
every routing call of those steps, through the program's
``ops/moe.py::record_routes``); the warm-up. The window runs
``train_step`` until ``--seconds`` have passed and waits for the card; the
rate is the samples over all of that time. A traced run then profiles
``trace_steps`` more steps (:func:`bench_lib.tracing.profile`), runs them
once more under a CUDA-only profiler for the device time of the kernels
named ``moe_expert_*`` and the grouped wrappers' launches, and once more
with the program's spans and counters collected (the routing spans' self
time, the device tally of rows an expert). Once the window has closed and
the peak memory has been read, the program is freed and the reference
(:mod:`reference.moonlight`) runs the first steps again from the same
weights and batches, taking the program's expert choice where its own is
within ``check.route_margin`` of a tie.
"""

from __future__ import annotations

import gc
import os
import shutil
import time
from typing import Dict, List

from bench_lib import compare, moe, tracing
from bench_lib.cells import BENCH_DIR, _module
from bench_lib.env import CACHE_DIR, process_start
from bench_lib.program import counters, tokenizer_dir
from bench_lib.record import RunRecord
from bench_lib.seeds import mix

# the pool of batches is the ``train`` cells' (the same rows from the same seed)
make_pool = _module(os.path.join(BENCH_DIR, "drivers", "train.py"), "bench_driver_train").make_pool

STATE_SALT = 0xD50F_0003


def program_cfgs(cfg: Dict, vocab: int):
    """The program's resolved (encoder, decoder) cfgs of the configuration's
    ``program_model``; raises at once when the program does not have it."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs

    model_cfg = get_model_config(cfg["program_model"])
    if model_cfg is None:
        raise SystemExit(f"the program has no model {cfg['program_model']!r}")
    enc_cfg, dec_cfg, _ = resolve_cruller_cfgs(model_cfg, vocab_size=vocab)
    moe.check_sizes(cfg, enc_cfg, dec_cfg)
    return enc_cfg, dec_cfg


def make_task(cell, device: str, weights: Dict, dtype: str = "bfloat16"):
    """The cell's registered train task on ``device``, given ``weights`` as
    its checkpoint (:func:`bench_lib.program.make_task` without the BART
    decoder's size check; :func:`program_cfgs` checks the sizes)."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    p, cfg = cell.params, cell.cfg
    _, cfg_cls = TASK_CLASS_REGISTRY[p["task"]]
    task_cfg = cfg_cls(model_name=cfg["program_model"],
                       tokenizer=TokenizerCfg(name=tokenizer_dir(cfg, False)), dtype=dtype,
                       device=device, opt=OptimizationCfg(**p["opt"]),
                       num_intervals=p["num_intervals"],
                       num_warmup_intervals=p["num_warmup_intervals"], remat=p.get("remat"))
    task, _ = TaskFactory.create_task(p["task"], task_cfg, DeviceEnv.initialize(device))
    if task.vocab_size != cfg["vocab_size"]:
        raise ValueError(f"the task's vocabulary is {task.vocab_size}, the configuration's "
                         f"{cfg['vocab_size']}")
    task.resume_state_dict = weights
    return task


def read_counts() -> Dict[str, int]:
    from pixparse_tpu_torch.ops.moe import moe_expert_mm, moe_expert_wgrad

    fns = dict(counters(), moe_expert_mm=moe_expert_mm, moe_expert_wgrad=moe_expert_wgrad)
    return {k: int(getattr(fn, "launches", 0)) for k, fn in fns.items()}


def _routes(torch, recorded) -> List:
    return [(r.experts.to(torch.int16).cpu(), r.scores.cpu()) for r in recorded]


def moe_pass(torch, run_steps, scratch: str) -> Dict:
    """``run_steps()`` under a CUDA-only profiler: the device time of the
    kernels named ``moe_expert_*`` and the grouped wrappers' launches."""
    from torch.profiler import ProfilerActivity

    os.makedirs(scratch, exist_ok=True)
    try:
        before = read_counts()
        events, _ = tracing._traced(torch, run_steps, [ProfilerActivity.CUDA],
                                    os.path.join(scratch, "moe.json"))
        after = read_counts()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    device_s = sum(float(e["dur"]) * 1e-6 for e in events
                   if e.get("cat") == "kernel" and "moe_expert_" in e.get("name", ""))
    return {"device_s": device_s,
            "launches": {k: after[k] - before[k] for k in ("moe_expert_mm", "moe_expert_wgrad")}}


def run(cell, args, torch, device: str = "cuda") -> RunRecord:
    p, cfg = cell.params, cell.cfg
    seed = args.seed
    program_cfgs(cfg, cfg["vocab_size"])
    from pixparse_tpu_torch.framework.profiling import collect
    from pixparse_tpu_torch.ops.moe import record_routes

    weights = moe.seeded_weights(torch, cfg, seed, device)
    task = make_task(cell, device, weights)
    del weights
    base_seed = mix(seed, STATE_SALT) % (1 << 31)
    task.train_setup(num_batches_per_interval=p["batches_per_interval"], seed=base_seed)
    pool = make_pool(cell, task, seed)
    first_steps = p["first_steps"]
    if first_steps > len(pool):
        raise ValueError("the first steps need rows that all differ: pool_batches >= first_steps")
    b1 = (p["opt"].get("betas") or (0.9, 0.999))[0]

    losses, routes = [], []
    for k in range(first_steps):
        with record_routes() as recorded:
            losses.append(task.train_step(pool[k])["loss"])
        routes.append(_routes(torch, recorded))
        if k == 0:  # the first moments are the program's: no name of this frame keeps them
            norms = torch._foreach_norm([task.state.opt_state["mu"][n].float()
                                         for n in task.state.params])
            grad_norms = {n: float(v) / (1.0 - b1) for n, v in zip(task.state.params, norms)}
    prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "delta_norms": moe.delta_norms(torch, cfg, seed, task.state.params, device),
            "routes": routes}
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

    text_len = p["text_positions"] - 1
    window = {"seconds": window_s, "steps": steps, "samples": steps * p["batch"],
              "flops": steps * moe.train_step_flops(cfg, p["batch"], text_len),
              "trace_steps": p["trace_steps"], "batch": p["batch"], "text_len": text_len,
              "trace_valid_targets": []}
    trace, launches = None, None
    if args.trace:
        passes = []  # each profiled pass's valid targets a step

        def steps_of_trace():
            nonlocal at
            valid = []
            for _ in range(p["trace_steps"]):
                batch = pool[at % len(pool)]
                with spans("train_step"):
                    task.train_step(batch)
                valid.append(int((batch["target"][:, 1:] != -100).sum()))
                at += 1
            passes.append(valid)

        trace = tracing.profile(torch, steps_of_trace, f"{CACHE_DIR}/trace-{args.seed}",
                                counts=read_counts)
        launches = trace["wrapper_launches"]
        window["trace_valid_targets"] = passes[0]  # the device pass's
        if device != "cpu":
            window["moe_pass"] = moe_pass(torch, steps_of_trace, f"{CACHE_DIR}/moe-{args.seed}")
        with collect() as collected:
            steps_of_trace()
            tracing.sync(torch)
        totals = collected.totals()
        route_s = sum(totals.get(n, {}).get("self_s", 0.0) for n in ("moe.route", "moe.combine"))
        window["moe_route_ms"] = 1e3 * route_s / p["trace_steps"]
        window["expert_rows"] = collected.read_tallies()

    rec = RunRecord(cell=cell, seed=seed, setup_s=setup_s, memory_peak_bytes=peak,
                    attempted=steps, failed=0, spans=spans, trace=trace, launches=launches,
                    window=window)
    rec.e2e = {"train_samples_per_s": steps * p["batch"] / window_s,
               "peak_memory_gib": peak / 2 ** 30, "setup_s": setup_s}

    del task
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_readings(torch, cell, seed, pool[:first_steps], device, "fp32", routes)
    rec.window["check_s"] = time.perf_counter() - t_check
    numbers = check_numbers(torch, prog, ref)
    rec.checks = compare.checks(numbers, cell.spec["check"]["limits"])
    rec.check_inputs = {"batches": pool[:first_steps], "ref": ref, "numbers": numbers}
    return rec


def check_numbers(torch, prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``delta_gap`` as the ``train`` cells
    read them, and ``route_gap`` (with ``score_gap`` beside it) of
    :mod:`bench_lib.moe`."""
    numbers = compare.train_numbers(prog, ref)
    numbers.update(moe.route_numbers(torch, prog["routes"], ref["routes"]))
    return numbers


def control_numbers(torch, cell, rec, device: str = "cuda") -> Dict:
    """The control's numbers on the run's own inputs: the reference in fp8
    in the program's place (its routing its own)."""
    ins = rec.check_inputs
    ctrl = reference_readings(torch, cell, rec.seed, ins["batches"], device, "fp8", None)
    ctrl["routes"] = [[(own, scores) for scores, own, _ in step] for step in ctrl["routes"]]
    return check_numbers(torch, ctrl, ins["ref"])


def reference_readings(torch, cell, seed, batches, device, numerics: str, follow) -> Dict:
    """The reference's readings of the same first steps from the seeded
    weights (``numerics`` ``fp8``: the control), taking ``follow``'s expert
    choices within ``check.route_margin`` of a tie."""
    from reference.moonlight import train_readings
    from reference.numerics import Numerics, exact_matmuls

    p, cfg = cell.params, cell.cfg
    opt = dict(p["opt"], num_intervals=p["num_intervals"],
               num_warmup_intervals=p["num_warmup_intervals"],
               updates_per_interval=p["batches_per_interval"])
    chk = cell.spec["check"]
    follow = None if follow is None else [[experts for experts, _ in step] for step in follow]
    with exact_matmuls():
        params = moe.seeded_weights(torch, cfg, seed, device)
        out = train_readings(params, cfg, Numerics(numerics), batches, opt, chk["chunk_rows"],
                             device, chk["route_margin"], follow)
        fixed = set(n for n in params if n.endswith("e_score_correction_bias"))
        out["delta_norms"] = moe.delta_norms(
            torch, cfg, seed, {n: t for n, t in params.items() if n not in fixed}, device)
    del params
    gc.collect()
    return out
