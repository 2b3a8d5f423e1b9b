"""mfu.eval: the eval batches' matmul FLOPs (encoder, cross K/V, every
position's decoder layers and tied head: bench_lib.flops.eval_batch_flops)
over the window's time and the card's published bf16 peak, in %."""

from bench_lib.peaks import peaks_for


def read(rec):
    w = rec.window
    if not w.get("batches"):
        return None
    pk = peaks_for(rec.card)
    return None if pk is None else 100.0 * w["flops"] / w["seconds"] / pk.bf16_flops
