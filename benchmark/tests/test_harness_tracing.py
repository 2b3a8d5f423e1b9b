"""The trace summary on a hand-made chrome trace: overlapping kernels
count once, idle gaps carry what the host was doing, launches count per
span, and kernels fall into their families."""

from bench_lib.families import family_of
from bench_lib.tracing import device_summary, summarize


def ev(cat, name, ts=0, dur=0, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_summary_of_a_hand_made_trace():
    events = [
        ev("user_annotation", "bench.window", 0, 100),
        ev("user_annotation", "bench.encode", 0, 40),
        ev("user_annotation", "bench.generate", 40, 60),
        ev("cpu_op", "aten::linear", 5, 10),
        ev("cpu_op", "aten::mm", 6, 8),  # held by aten::linear
        ev("cpu_op", "aten::item", 60, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 41, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1),
        ev("cuda_runtime", "cudaMemcpyAsync", 43, 1),
        ev("kernel", "flash_fwd_wgmma_kernel<64>", 10, 20, tid=7),
        ev("kernel", "nvjet_hsh_128x256_gemm", 20, 20, tid=8),  # overlaps the first
        ev("kernel", "decode_attn_split_kernel<bf16, 64>", 50, 10, tid=7),
        ev("gpu_memcpy", "Memcpy HtoD", 95, 10, tid=7),  # runs past the window's end
    ]
    s = summarize(events)
    assert abs(s["window_s"] - 100e-6) < 1e-12
    # [10, 40] + [50, 60] + [95, 100]
    assert abs(s["busy_s"] - 45e-6) < 1e-12
    d = device_summary(events)
    assert d["family_calls"] == {"flash": 1, "gemm": 1, "decode_attn": 1, "copy": 1}
    assert abs(d["family_s"]["flash"] - 20e-6) < 1e-12
    assert s["launches"] == {"encode": 1, "generate": 2}
    idle = dict((k, v) for k, v in s["idle"])
    assert abs(idle["encode: aten::linear"] - 10e-6) < 1e-12  # [0, 10]: aten::linear at its middle
    assert abs(idle["generate: no host op"] - 10e-6) < 1e-12  # [40, 50]
    assert abs(idle["generate: aten::item"] - 35e-6) < 1e-12  # [60, 95]


def test_device_pass_summary_counts_every_device_operation_once():
    """The device pass has no host ranges: every device operation of the
    trace counts, overlapping ones once."""
    events = [
        ev("cuda_runtime", "cudaLaunchKernel", 0, 1),
        ev("kernel", "flash_fwd_wgmma_kernel<64>", 10, 20, tid=7),
        ev("kernel", "nvjet_hsh_128x256_gemm", 20, 20, tid=8),
        ev("gpu_memcpy", "Memcpy HtoD", 95, 10, tid=7),
        ev("kernel", "no duration"),
    ]
    del events[-1]["dur"]
    s = device_summary(events)
    assert abs(s["busy_s"] - 40e-6) < 1e-12  # [10, 40] + [95, 105]
    assert s["device_calls"] == 3
    assert s["family_calls"] == {"flash": 1, "gemm": 1, "copy": 1}
    assert s["top_ops"][0][0] == "flash_fwd_wgmma_kernel<64>"


def test_families():
    assert family_of("flash_bwd_dq_wgmma_kernel<64>") == "flash"
    assert family_of("void ce_gemm_kernel<1, 128>(CUtensorMap)") == "fused_ce"
    assert family_of("window_fwd_ring_kernel<32, 2>") == "window"
    assert family_of("window_bwd_ring_kernel<32, 2, true>") == "window"
    assert family_of("decode_attn_split_kernel<__nv_bfloat16, 64>") == "decode_attn"
    assert family_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert family_of("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert family_of("something_new") == "other"
