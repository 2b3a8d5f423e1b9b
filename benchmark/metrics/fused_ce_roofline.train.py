"""fused_ce_roofline.train: the fused cross-entropy kernels' (csrc/fused_ce.cu)
summed bounds over their device time in the traced train steps, in %. Work
2 T V D forward and 6 T V D backward over the T valid targets; bytes the
hidden rows and the table once each way (bench_lib.bounds)."""

from bench_lib import bounds
from bench_lib.peaks import peaks_for


def read(rec):
    t, w = rec.trace, rec.window
    dec = rec.cell.cfg["decoder"]
    if not t or t["family_s"].get("fused_ce", 0.0) <= 0.0:
        return None
    steps = len(w["trace_valid_targets"])
    launches = rec.launches or {}
    if launches.get("fused_ce_fwd") != steps or launches.get("fused_ce_bwd") != steps:
        return None
    V, D = dec["vocab_size"], dec["d_model"]
    calls = []
    for T in w["trace_valid_targets"]:
        calls += [bounds.fused_ce_fwd(T, V, D), bounds.fused_ce_bwd(T, V, D)]
    pk = peaks_for(rec.card)
    if pk is None:
        return None
    return 100.0 * bounds.seconds(calls, pk.bf16_flops, pk.hbm_bytes) / t["family_s"]["fused_ce"]
