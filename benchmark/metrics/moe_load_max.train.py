"""moe_load_max.train: the mean over expert layers of the busiest expert's
rows over the mean rows an expert (1: even loads), from the program's
device tally moe.expert_rows over the collected pass of the traced steps."""

from bench_lib.moe import load_max


def read(rec):
    return load_max(rec.window.get("expert_rows"))
