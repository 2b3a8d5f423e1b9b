"""Spans and the profiled sub-window.

:class:`Spans` is the benchmark's own host-clock spans around its calls
into the program (``bench.<name>``), and with a profiler running the same
names as ``record_function`` ranges, so that the trace can tell which one
was active.

:func:`profile` runs a callable twice under ``torch.profiler``, exports
each chrome trace into a scratch directory, reads it back and keeps a
summary only. The first pass records CUDA activity alone, so that the
device numbers come from a trace without host-operator records. Either
pass stretches a host-paced step, so idle shares are read against the
untraced window (the metric readers). From the first pass:

- ``window_s``: the pass's wall time, the card waited for at both ends;
- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills) in it, so overlapping kernels count once;
- ``family_s`` / ``family_calls``: device time and calls by kernel family
  (:mod:`bench_lib.families`), summed per kernel;
- ``top_ops``: the kernels that took most device time;
- ``wrapper_launches``: the kernel wrappers' launches in it (``counts``).

The second pass records host operators too, and gives only what needs
them, all exact or attributions rather than times of the step:

- ``launches``: host launch calls inside each span name;
- ``idle``: the device's idle time in that pass by what the host was doing
  (the innermost benchmark span, then the outermost host operator running
  at the gap's middle); the pass's own ``host_window_s`` and
  ``host_busy_s`` say how much the host recording stretched it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from bench_lib.families import family_of

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(torch) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Host-clock spans; ``sync`` waits for the device at each end (only in
    a traced run: the untraced window never waits for the spans)."""

    def __init__(self, torch, sync: bool):
        self.torch = torch
        self.sync = sync
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        torch = self.torch
        if self.sync:
            sync(torch)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
            if self.sync:
                sync(torch)
        self.records.append((name, time.perf_counter() - t0))

    def total(self, name: str) -> float:
        return sum(s for n, s in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _ in self.records if n == name)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(ranges: List[Tuple[float, float, str]], starts: List[float], t: float) -> Optional[str]:
    """Name of the innermost range (latest start) that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    while i >= 0:
        a, b, name = ranges[i]
        if a <= t <= b:
            best = name
            break
        i -= 1
        if starts[i + 1] < t - 600e6:  # no range lasts ten minutes
            break
    return best


def _top_level(ops: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The operators of one thread that no other operator holds (sorted by
    start, so disjoint)."""
    out: List[Tuple[float, float, str]] = []
    for a, b, name in sorted(ops):
        if not out or a >= out[-1][1]:
            out.append((a, b, name))
    return out


def _holding(ranges: List[Tuple[float, float, str]], starts: List[float], t: float) -> Optional[str]:
    """Name of the range of disjoint ``ranges`` that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i][2]
    return None


def summarize(events: List[dict]) -> Dict:
    """The host pass's summary of one exported chrome trace's
    ``traceEvents``: the ``bench.window`` range's length, the device's busy
    time inside it, launches per span and idle time by host activity."""
    window = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == "bench.window"]
    if not window:
        raise ValueError("the trace has no bench.window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    busy, spans, launches = [], [], []
    ops: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    main = window[0].get("tid")
    for e in events:
        cat = e.get("cat")
        if "dur" not in e or "ts" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            if b > w0 and a < w1:
                busy.append((max(a, w0), min(b, w1)))
        elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
            if e["name"] != "bench.window":
                spans.append((a, b, e["name"][len("bench."):]))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((a, b, e.get("name", "")))
        elif cat == "cuda_runtime" and "Launch" in e.get("name", ""):
            launches.append(a)
    busy = _merge(busy)
    spans.sort()
    span_starts = [s[0] for s in spans]
    # the main thread's operators first, then the others' (the autograd engine's)
    threads = sorted(ops, key=lambda tid: tid != main)
    tops = [_top_level(ops[tid]) for tid in threads]
    top_starts = [[o[0] for o in t] for t in tops]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        span = _innermost(spans, span_starts, mid) or "outside"
        op = next((n for t, st in zip(tops, top_starts)
                   for n in (_holding(t, st, mid),) if n), "no host op")
        idle[f"{span}: {op}"] += (b - a) * 1e-6
    launches.sort()
    span_launches: Dict[str, int] = defaultdict(int)
    for a, b, name in spans:
        span_launches[name] += bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "launches": dict(span_launches),
        "idle": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
    }


def device_summary(events: List[dict]) -> Dict:
    """Busy time, families and top kernels of a whole exported trace."""
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
              for e in events if e.get("cat") in DEVICE_CATS and "dur" in e and "ts" in e]
    busy = _merge([(a, b) for a, b, _ in device])
    family_s: Dict[str, float] = defaultdict(float)
    family_calls: Dict[str, int] = defaultdict(int)
    by_kernel: Dict[str, float] = defaultdict(float)
    for a, b, n in device:
        fam = family_of(n)
        family_s[fam] += (b - a) * 1e-6
        family_calls[fam] += 1
        by_kernel[n] += (b - a) * 1e-6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "family_s": dict(family_s),
        "family_calls": dict(family_calls),
        "device_calls": len(device),
        "top_ops": [[n[:96], s] for n, s in top],
    }


def _traced(torch, fn: Callable[[], None], activities, path: str) -> Tuple[List[dict], float]:
    """Run ``fn`` once under the profiler inside a ``bench.window`` range;
    the exported trace's events and the wall time, the card waited for."""
    from torch.profiler import record_function
    from torch.profiler import profile as torch_profile

    sync(torch)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function("bench.window"):
            fn()
            sync(torch)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    return events, wall


def profile(torch, fn: Callable[[], None], scratch: str,
            counts: Callable[[], Dict[str, int]]) -> Dict:
    """Run ``fn`` in the device pass and then in the host pass (the module's
    docstring) and return their summary. ``counts`` reads the kernel
    wrappers' launch counters around the device pass."""
    from torch.profiler import ProfilerActivity

    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, "trace.json")
    on_card = torch.cuda.is_available()
    try:
        before = counts()
        events, wall = _traced(torch, fn, [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU],
                               path)
        after = counts()
        out = device_summary(events)
        out["window_s"] = wall
        out["wrapper_launches"] = {k: after[k] - before[k] for k in after}
        del events
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        host = summarize(_traced(torch, fn, activities, path)[0])
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out.update(launches=host["launches"], idle=host["idle"],
               host_window_s=host["window_s"], host_busy_s=host["busy_s"])
    return out
