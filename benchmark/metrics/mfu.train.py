"""mfu.train: the whole train step's matmul FLOPs (bench_lib.flops, the
program's convention) times the window's steps, over the window's time and
the card's published bf16 peak, in %."""

from bench_lib.peaks import peaks_for


def read(rec):
    w = rec.window
    if not w.get("steps"):
        return None
    pk = peaks_for(rec.card)
    return None if pk is None else 100.0 * w["flops"] / w["seconds"] / pk.bf16_flops
