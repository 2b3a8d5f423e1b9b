"""decode_attn_roofline.eval: the decode-attention kernel's
(csrc/decode_attention.cu) summed bounds over its device time in the traced
eval batch, in %. Each decode step attends, in every layer, over the self
keys written so far (the prompt's real tokens and the tokens generated) and
over the encoder rows: 4 H D a valid key; bytes the valid keys' K and V, q
and o, the key mask (bench_lib.bounds)."""

from bench_lib import bounds
from bench_lib.flops import encoder_tokens
from bench_lib.peaks import peaks_for


def _pad128(n):
    return -(-n // 128) * 128


def read(rec):
    t, w = rec.trace, rec.window
    steps = w.get("traced_steps")
    if not t or not steps or t["family_s"].get("decode_attn", 0.0) <= 0.0:
        return None
    cfg = rec.cell.cfg
    dec = cfg["decoder"]
    layers, H = dec["layers"], dec["heads"]
    Dh = dec["d_model"] // H
    if (rec.launches or {}).get("decode_attention") != 2 * layers * steps:
        return None
    real = t["batch_real"]
    B = len(real)
    Lk = encoder_tokens(cfg["encoder"])
    max_len = t["batch_prompt_cols"] + rec.cell.params["new_tokens"]
    calls = []
    for s in range(1, steps + 1):
        self_keys = sum(n + s for n in real)
        calls += [bounds.decode_attention(B, self_keys, H, Dh, _pad128(max_len)),
                  bounds.decode_attention(B, B * Lk, H, Dh, _pad128(Lk))]
    pk = peaks_for(rec.card)
    if pk is None:
        return None
    bound = layers * bounds.seconds(calls, pk.bf16_flops, pk.hbm_bytes)
    return 100.0 * bound / t["family_s"]["decode_attn"]
