"""flash_roofline.train: the flash kernels' (csrc/flash_attention.cu,
flash_attention_bwd.cu) summed bounds over their device time in the traced
train steps, in %. Work 4 H D a visible pair forward, 10 H D backward;
bytes each input and output once (bench_lib.bounds)."""

from bench_lib.rooflines import flash_train_calls, share


def read(rec):
    w = rec.window
    fwd, bwd = flash_train_calls(rec.cell.cfg, w["batch"], w["text_len"])
    n = len(fwd)
    return share(rec, "flash", fwd + bwd,
                 {"flash_attention_fwd": n, "flash_attention_bwd": n})
