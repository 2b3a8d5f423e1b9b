"""decode_step_ms.eval: the benchmark's span around generate (prefill, the
decode loop and the tokens' copy to the host) over the decode steps it ran,
summed over the traced run's window (the profiled batches left out), in
ms."""


def read(rec):
    spans, steps = rec.window.get("span_s", {}).get("generate"), rec.window.get("decode_steps")
    return 1e3 * sum(spans) / steps if spans and steps else None
