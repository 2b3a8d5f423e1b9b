"""The per-layer readers on a hand-made record of a card run: shares of a
roofline or a peak come out at most 100 for times at or above the bound,
and a reader finds nothing where its kernels did not run as the shapes
say."""

import os
from types import SimpleNamespace

import pytest

from bench_lib import bounds
from bench_lib.cells import Cell
from bench_lib.peaks import peaks_for
from bench_lib.rooflines import flash_train_calls, window_train_calls
from bench_lib.tracing import Spans
from checkout import BENCH, load

H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    from bench_lib.cells import _module

    return _module(os.path.join(BENCH, "metrics", f"{name}.py"), "m_" + name.replace(".", "_"))


def cell(config, params):
    return Cell("x", {}, {"params": params}, load(os.path.join(BENCH, "configs", f"{config}.json")),
                [], [])


def record(c, window, trace, launches, card=H100):
    spans = Spans(SimpleNamespace(), sync=False)
    return SimpleNamespace(cell=c, window=window, trace=trace, launches=launches, card=card,
                           spans=spans)


def test_flash_roofline_is_100_at_the_bound_and_silent_on_a_wrong_count():
    c = cell("cruller_base", {})
    fwd, bwd = flash_train_calls(c.cfg, 32, 1023)
    assert len(fwd) == 20
    pk = peaks_for(H100)
    bound = 3 * bounds.seconds(fwd + bwd, pk.bf16_flops, pk.hbm_bytes)
    window = {"trace_steps": 3, "batch": 32, "text_len": 1023}
    trace = {"family_s": {"flash": bound}}
    good = {"flash_attention_fwd": 60, "flash_attention_bwd": 60}
    assert reader("flash_roofline.train").read(record(c, window, trace, good)) == pytest.approx(100.0)
    trace = {"family_s": {"flash": 2 * bound}}
    assert reader("flash_roofline.train").read(record(c, window, trace, good)) == pytest.approx(50.0)
    bad = {"flash_attention_fwd": 59, "flash_attention_bwd": 60}
    assert reader("flash_roofline.train").read(record(c, window, trace, bad)) is None
    assert reader("flash_roofline.train").read(record(c, window, trace, good, card="cpu")) is None


def test_window_calls_cover_every_swin_block():
    c = cell("donut_base", {})
    fwd, bwd = window_train_calls(c.cfg, 2)
    assert len(fwd) == len(bwd) == 20
    # stage 0: 640 x 480 tokens in 10 x 10 windows, 128 channels, the first block unshifted
    assert fwd[0] == bounds.window_fwd(2 * 64 * 48, 100, 128, 4, 0)
    assert window_train_calls(cell("cruller_base", {}).cfg, 2) == ([], [])


def test_decode_roofline_counts_the_valid_keys():
    c = cell("cruller_base", {"new_tokens": 3})
    window = {"traced_steps": 2}
    trace = {"family_s": {"decode_attn": 1.0}, "batch_real": [1, 1], "batch_prompt_cols": 1}
    r = reader("decode_attn_roofline.eval")
    assert r.read(record(c, window, trace, {"decode_attention": 15})) is None
    got = r.read(record(c, window, trace, {"decode_attention": 16}))
    pk = peaks_for(H100)
    calls = []
    for s in (1, 2):
        calls += [bounds.decode_attention(2, 2 * (1 + s), 12, 64, 128),
                  bounds.decode_attention(2, 2 * 1009, 12, 64, 1024)]
    assert got == pytest.approx(100.0 * 4 * bounds.seconds(calls, pk.bf16_flops, pk.hbm_bytes))


def test_mfu_idle_and_spans():
    c = cell("cruller_base", {})
    rec = record(c, {"steps": 10, "flops": 989e12, "seconds": 2.0, "decode_steps": 4,
                     "trace_steps": 5, "batches": 2},
                 {"busy_s": 0.75, "window_s": 1.0, "launches": {"generate": 50}}, {})
    rec.window["traced_steps"] = 4
    assert reader("mfu.train").read(rec) == pytest.approx(50.0)
    # busy a step 0.15 s of the window's 0.2 s a step; the traced pass's own
    # window (1.0 s) is not what a step takes
    assert reader("idle_share.train").read(rec) == pytest.approx(25.0)
    assert reader("idle_share.eval").read(rec) == pytest.approx(25.0)  # 0.75 s of 1.0 a batch
    assert reader("kernels_per_step.eval").read(rec) == pytest.approx(10.0)
    # the window's spans only: a profiled batch's own spans are not read
    rec.window["span_s"] = {"generate": [0.002, 0.006], "encode": [0.004]}
    rec.spans.records += [("generate", 0.002), ("encode", 0.004), ("generate", 0.006),
                          ("encode", 1.0), ("generate", 1.0)]
    assert reader("decode_step_ms.eval").read(rec) == pytest.approx(2.0)
    assert reader("encode_ms.eval").read(rec) == pytest.approx(4.0)


def test_every_reader_is_silent_without_a_trace():
    for f in sorted(os.listdir(os.path.join(BENCH, "metrics"))):
        name = f[:-3]
        if name.startswith(("mfu", "encode", "decode_step")):
            continue
        rec = record(cell("cruller_base", {"new_tokens": 1}), {"trace_steps": 1, "batch": 1,
                     "text_len": 3, "traced_steps": 1, "trace_valid_targets": [1]}, None, None)
        assert reader(name).read(rec) is None, name
