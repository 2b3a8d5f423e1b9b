"""moe_expert_roofline.train: the grouped expert kernels' (csrc/moe_expert_mm.cu)
summed bounds over their device time in the traced train steps, in %. Per
expert layer and step six products over the layer's (token, slot) rows:
operations 2 rows K N each, bytes the rows in, the weights of experts with
rows and the output once each (bench_lib.moe.expert_calls). The device time
is the CUDA-only pass's kernels named moe_expert_*; None unless that pass
launched what the shapes give."""

from bench_lib import bounds, moe
from bench_lib.flops import encoder_tokens
from bench_lib.peaks import peaks_for


def read(rec):
    w, cfg = rec.window, rec.cell.cfg
    run = w.get("moe_pass")
    rows = w.get("expert_rows")
    if not run or not rows or run["device_s"] <= 0:
        return None
    steps = w["trace_steps"]
    if any(run["launches"].get(k) != n * steps for k, n in moe.expert_launches(cfg).items()):
        return None
    pk = peaks_for(rec.card)
    if pk is None:
        return None
    tokens = w["batch"] * (encoder_tokens(cfg["encoder"]) + w["text_len"])
    R = tokens * cfg["num_experts_per_tok"]
    calls = []
    for counts in rows.values():
        calls += moe.expert_calls(cfg, R, sum(1 for n in counts if n))
    if len(rows) != cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]:
        return None
    return 100.0 * steps * bounds.seconds(calls, pk.bf16_flops, pk.hbm_bytes) / run["device_s"]
