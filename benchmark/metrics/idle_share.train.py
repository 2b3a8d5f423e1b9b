"""idle_share.train: the share of a train step in which the card runs
nothing, in %: 1 - the device's busy time a step over the untraced window's
time a step. The busy time is the union of the device operations'
intervals in the profiler's device pass (CUDA activity only); the step's
time comes from the window, since even that pass stretches the step (by
~15% at cruller_base, B=32)."""


def read(rec):
    t, w = rec.trace, rec.window
    if not t or not w.get("steps") or not w.get("trace_steps") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / w["trace_steps"]) / (w["seconds"] / w["steps"]))
