"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and
loaded with :mod:`ctypes`. All sources build at once, one ``nvcc`` process
each, started together. A library's file name carries a hash of its source,
of every shared header (``csrc/*.cuh``) and of the flags, so an edited source
or header never loads a stale build. The build
directory (``pixparse_tpu_torch/csrc/build``) is listed in ``.gitignore``.

Pointers and the CUDA stream cross the boundary as ``ctypes.c_void_p``;
every C entry returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(CSRC),
]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C signatures of the entry points, by source stem
SIGNATURES = {
    "flash_attention": {
        "pixparse_flash_attn_fwd": [
            I, P, P, P, P, P, P, I, I, I, I, I, LL, LL, LL, LL, LL, LL, I, F, P,
        ],
    },
    "decode_attention": {
        "pixparse_decode_attn_fwd": [
            I, P, P, P, P, P, P, P, I, I, I, I, LL, LL, LL, LL, I, I, I, F, P,
        ],
    },
    "flash_attention_bwd": {
        "pixparse_flash_attn_bwd": [
            I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
            LL, LL, LL, LL, LL, LL, LL, LL, I, F, P,
        ],
    },
    "fused_ce": {
        "pixparse_fused_ce_fwd": [I, P, P, P, P, P, P, I, I, I, P],
        "pixparse_fused_ce_bwd": [I, P, P, P, P, P, P, P, P, P, I, I, I, I, P],
    },
    "window_attention": {
        "pixparse_window_attn_fwd": [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, LL, LL, LL, LL, LL, LL, F, P,
        ],
        "pixparse_window_attn_fwd_config": [I, I, I, I, P],
    },
    "window_attention_bwd": {
        "pixparse_window_attn_bwd": [
            I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
            LL, LL, LL, LL, LL, LL, LL, LL, F, P,
        ],
        "pixparse_window_attn_bwd_config": [I, I, I, I, P],
    },
    "layer_norm": {
        "pixparse_layer_norm_fwd": [I, P, P, P, P, I, I, I, F, P],
        "pixparse_layer_norm_fwd_blocks_per_sm": [I, I],
        "pixparse_layer_norm_bwd": [I, P, P, P, P, P, P, P, I, I, I, F, P],
        "pixparse_layer_norm_bwd_blocks_per_sm": [I, I],
    },
    "decode_attention_q8": {
        "pixparse_decode_attn_q8_fwd": [
            I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, LL, LL, LL, LL, LL, LL,
            I, I, I, I, I, I, F, P,
        ],
        "pixparse_decode_attn_q8_blocks_per_sm": [I, I],
    },
    # the probe tools' kernels (pixparse_tpu_torch/tools)
    "mxu_probe": {
        "pixparse_mxu_probe": [I, P, P, P, I, I, I, I, I, P],
        "pixparse_mxu_probe_blocks_per_sm": [I],
    },
    "window_band": {
        "pixparse_window_band_fwd": [P, P, P, I, I, I, I, I, I, I, I, I, F, P],
        "pixparse_window_band_config": [I, I, P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on first use"
    )


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (all ``nvcc`` processes run at once),
    then load and type every entry point. Idempotent and thread-safe."""
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {s: _lib_path(s) for s in SIGNATURES if not _lib_path(s).exists()}
        if todo:
            nvcc = _nvcc()
            procs = {}
            for stem, out in todo.items():
                tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
                procs[stem] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                    ),
                    tmp,
                    out,
                )
            failed = []
            for stem, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                out.with_suffix(".log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for stem, entries in SIGNATURES.items():
            lib = ctypes.CDLL(str(_lib_path(stem)))
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[stem] = lib
        return _libs


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]


def ptxas_log(stem: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the library was built (registers,
    shared memory, spills per kernel); empty if it was built elsewhere."""
    log = _lib_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
