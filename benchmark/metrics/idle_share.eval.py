"""idle_share.eval: the share of an eval batch in which the card runs
nothing, in %: 1 - the device's busy time in the traced batch over the
window's time a batch. The busy time is the union of the device
operations' intervals in the profiler's device pass (CUDA activity only);
the batch's time comes from the window, since even that pass stretches the
host-paced decode loop."""


def read(rec):
    t, w = rec.trace, rec.window
    if not t or not w.get("batches") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / (w["seconds"] / w["batches"]))
