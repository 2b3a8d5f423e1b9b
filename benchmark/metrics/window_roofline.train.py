"""window_roofline.train: the Swin window-attention kernels'
(csrc/window_attention.cu, window_attention_bwd.cu) summed bounds over
their device time in the traced train steps, in %. Work 4 ww^2 C a window
forward, 10 ww^2 C backward (bench_lib.bounds)."""

from bench_lib.rooflines import share, window_train_calls


def read(rec):
    fwd, bwd = window_train_calls(rec.cell.cfg, rec.window["batch"])
    n = len(fwd)
    return share(rec, "window", fwd + bwd,
                 {"window_attention": n, "window_attention_bwd": n})
