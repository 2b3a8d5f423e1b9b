"""Per-phase timeline of the int8 decode kernel (#9) or the LayerNorm
backward (#13) on the card.

It builds a copy of the kernel's source in which thread 0 of every block
reads ``%globaltimer`` at the phase boundaries named below (text inserted
at fixed lines of the source; the copy is built beside the package's
libraries and swapped in under the wrapper), runs one call after the L2
flush with the card kept busy, and prints, per phase, the microseconds
from the first block's start at which the blocks passed it: min, median,
max. The build of the copy fails loudly if a line it looks for moved.

    python -m pixparse_tpu_torch.tools.kernel_timeline q8   # two cross caches
    python -m pixparse_tpu_torch.tools.kernel_timeline ln   # three LN shapes

It prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Optional, Sequence

import torch

from pixparse_tpu_torch.device import resolve_device
from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops import decode_attention as da
from pixparse_tpu_torch.ops import layer_norm as lnm

STAMP = ("if (threadIdx.x == 0 && {cond}) {{ unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); {arr}[blockIdx.{ax}][{k}] = t_; }}\n")

# (phase, "before"/"after", a line of csrc/decode_attention_q8.cu); blocks'
# first sample only
Q8_PHASES = [
    ("start", "before", "    // the split's mask: every load issued before any is used; the last\n"),
    ("mask_read", "after", "    const int n_keys = block_max_int(last, red) + 1;  // keys [lo, lo + n_keys) are read\n"),
    ("q_and_scales", "after", "    __syncthreads();  // plain-loaded scales\n"),
    ("k_pass", "before", "    // each head's (max, sum of exp) over the split, a warp per head\n"),
    ("stats_published", "before", "    float* st_sm = ks_sm;  // [split][2][H]\n"),
    ("met_1", "before", "    for (int h = warp; h < H; h += kWarps) {\n      constexpr int kPer"),
    ("pv_published", "before", "    // ps from the exact max over the splits; pv_i8"),
    ("met_2", "before", "    last = -1;\n"),
    ("quantized", "after", "    const int nV = (n_v + kt - 1) / kt;\n"),
    ("v_pass", "before", "    // V tiles issued before pv_i8 was known and not needed: wait them out\n"),
    ("partial_written", "before", "    if (tid == 0) red[kWarps] = atomic_add_acq_rel(a.counters + b, 1);\n"),
    ("end", "before", "    __syncthreads();  // shared memory is reused by the next sample\n"),
]

# csrc/layer_norm.cu: the row kernel's phases, then the partial-sum kernel's
LN_PHASES = [
    ("start", "before", "  for (int j = 0; j < n_local; ++j) {\n"),
    ("first_group", "after", "    mbar_wait(bar0 + 8 * s, (j / kBwdStages) & 1);\n", "j == 0"),
    ("rows_done", "before", '  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'),
]
LN_SUM_PHASES = [
    ("sum_start", "before", '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'),
    ("sum_waited", "after", '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'),
    ("sum_end", "before", "  if (col < D) dw[col] = t;\n"),
]


def _insert(src: str, phases, arr: str, cond: str, ax: str = "x") -> str:
    for k, (_, where, line, *own) in enumerate(phases):
        if src.count(line) != 1:
            raise RuntimeError(f"kernel_timeline: the line {line.strip()!r} moved")
        stamp = STAMP.format(cond=own[0] if own else cond, arr=arr, ax=ax, k=k)
        if ax == "q8":  # a (split, slot) grid
            stamp = stamp.replace("blockIdx.q8", "blockIdx.y * gridDim.x + blockIdx.x")
        src = src.replace(line, stamp + line if where == "before" else line + stamp)
    return src


def _build_copy(stem: str, text: str) -> ctypes.CDLL:
    cu = _build.CSRC / f"_timeline_{stem}.cu"
    so = _build.BUILD_DIR / f"lib_timeline_{stem}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    try:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                             capture_output=True, text=True)
    finally:
        cu.unlink()
    if out.returncode:
        raise RuntimeError(f"kernel_timeline: nvcc failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argt in _build.SIGNATURES[stem].items():
        getattr(lib, fn).argtypes = argt
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _spread(rows, names, t0):
    out = {}
    for k, name in enumerate(names):
        v = sorted((r[k] - t0) / 1e3 for r in rows)
        out[name] = [round(v[0], 2), round(v[len(v) // 2], 2), round(v[-1], 2)]
    return out


def _one_call(fn, flush):
    for _ in range(3):
        fn()
    flush.zero_()
    torch.cuda._sleep(200_000)
    fn()
    torch.cuda.synchronize()


def q8_timeline(flush) -> list:
    src = (_build.CSRC / "decode_attention_q8.cu").read_text()
    text = _insert(src, Q8_PHASES, "g_timeline", "b == (int)blockIdx.y", "q8")
    text = text.replace("struct Q8Args {", "__device__ unsigned long long g_timeline[4096][16];\n"
                        "struct Q8Args {", 1)
    text += ('\nextern "C" int pixparse_timeline(void* dst) {\n'
             "  return (int)cudaMemcpyFromSymbol(dst, g_timeline, sizeof(g_timeline));\n}\n")
    lib = _build_copy("decode_attention_q8", text)
    _build.library("decode_attention_q8")
    _build._libs["decode_attention_q8"] = lib
    da._q8_blocks_per_sm.cache_clear()
    out = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    # two caches that take the key splits (cruller_base's at B 16 takes a
    # block per head: decode_q8_by_heads)
    for name, B, Lk, valid, H, D in (("cross_b4_lk1024_valid1009", 4, 1024, 1009, 12, 64),
                                     ("donut_cross_b8_lk4864_valid4800", 8, 4864, 4800, 16, 64)):
        q = torch.randn(B, 1, H * D, device="cuda", generator=gen).bfloat16()
        (k8, ks), (v8, vs) = (da.quantize_kv_rows(
            torch.randn(B, Lk, H * D, device="cuda", generator=gen), H) for _ in range(2))
        mask = (torch.arange(Lk, device="cuda") < valid)[None].expand(B, Lk).contiguous()
        _one_call(lambda: da.decode_attention_q8(q, k8, v8, ks, vs, mask, H), flush)
        buf = (ctypes.c_ulonglong * (4096 * 16))()
        lib.pixparse_timeline(ctypes.cast(buf, ctypes.c_void_p))
        _, _, n_split, slots = da.decode_plan_q8(B, Lk, H, D, da._sm_count(0),
                                                 da._q8_blocks_per_sm(0, 1, D))
        rows = [[buf[i * 16 + k] for k in range(len(Q8_PHASES))] for i in range(n_split * slots)]
        out.append({"case": name, "blocks": n_split * slots,
                    "us": _spread(rows, [p[0] for p in Q8_PHASES], min(r[0] for r in rows))})
    return out


def ln_timeline(flush) -> list:
    src = (_build.CSRC / "layer_norm.cu").read_text()
    text = _insert(src, LN_PHASES, "g_rows", "true")
    text = _insert(text, LN_SUM_PHASES, "g_sums", "true")
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_rows[1024][8];\n"
                        "__device__ unsigned long long g_sums[2048][8];\n", 1)
    text += ('\nextern "C" int pixparse_timeline(void* rows, void* sums) {\n'
             "  cudaMemcpyFromSymbol(rows, g_rows, sizeof(g_rows));\n"
             "  return (int)cudaMemcpyFromSymbol(sums, g_sums, sizeof(g_sums));\n}\n")
    lib = _build_copy("layer_norm", text)
    _build.library("layer_norm")
    _build._libs["layer_norm"] = lib
    lnm._blocks_per_sm.cache_clear()
    out = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for R, D in ((3070, 1024), (38400, 512), (614400, 128)):
        x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        dy = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        w = torch.ones(D, device="cuda")
        _one_call(lambda: lnm.layer_norm_bwd(x, w, dy, 1e-5), flush)
        rows = (ctypes.c_ulonglong * (1024 * 8))()
        sums = (ctypes.c_ulonglong * (2048 * 8))()
        lib.pixparse_timeline(ctypes.cast(rows, ctypes.c_void_p), ctypes.cast(sums, ctypes.c_void_p))
        _, _, n_blocks = lnm.layer_norm_plan(R, D, 2, lnm._sm_count(0),
                                             lnm._blocks_per_sm("bwd", 0, 1, D))
        r = [[rows[i * 8 + k] for k in range(len(LN_PHASES))] for i in range(n_blocks)]
        s = [[sums[i * 8 + k] for k in range(len(LN_SUM_PHASES))] for i in range((2 * D + 31) // 32)]
        t0 = min(v[0] for v in r)
        us = _spread(r, [p[0] for p in LN_PHASES], t0)
        us.update(_spread(s, [p[0] for p in LN_SUM_PHASES], t0))
        out.append({"case": f"r{R}_d{D}_bfloat16", "blocks": n_blocks, "us": us})
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("q8", "ln"))
    args = ap.parse_args(argv)
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    recs = q8_timeline(flush) if args.kernel == "q8" else ln_timeline(flush)
    for rec in recs:
        print(json.dumps({"kernel": args.kernel, **rec}), flush=True)
    return recs


if __name__ == "__main__":
    main()
