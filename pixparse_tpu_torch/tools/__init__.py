"""Probe tools of the port: each asks one design question of the card with a
hand-written kernel, as the JAX package's ``tools/`` probes asked the TPU.

- :mod:`.mxu_probe`: tensor-core rate of K = 64 against K = 128 contractions
  and of 64-wide slices of a packed 128-wide buffer (kernel #16);
- :mod:`.window_band_probe`: Swin window attention read straight from the
  NHWC qkv map against partition -> window kernel -> reverse (kernel #17).

Importing a module here runs nothing; ``python -m
pixparse_tpu_torch.tools.<name>`` runs the probe on the card.
"""


def event_ms(fn, iters: int) -> float:
    """Mean ms of ``iters`` back-to-back calls of ``fn`` after one warm-up,
    between two CUDA events (the JAX tools' timing loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
