"""kernels_per_step.eval: device kernel launches the host made inside the
traced batch's generate span, over its decoder passes (the prefill and each
decode step): an exact count, from the profiler's host pass."""


def read(rec):
    t = rec.trace
    steps = rec.window.get("traced_steps")
    if not t or steps is None or "generate" not in t["launches"]:
        return None
    return t["launches"]["generate"] / (steps + 1)
