"""The run's surroundings: caches at fixed paths inside the checkout, the
card check, the process's start time, the card's name and power limit, and
the check that nothing of JAX or the JAX package was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

from bench_lib.cells import BENCH_DIR, ROOT

CACHE_DIR = os.path.join(BENCH_DIR, ".cache")  # listed in .gitignore
FORBIDDEN = ("jax", "jaxlib", "flax", "pixparse_tpu")


def set_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    libraries already build into ``pixparse_tpu_torch/csrc/build``), and
    ``transformers`` kept from loading flax. Call before importing torch."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def process_start() -> float:
    """Wall-clock time (``time.time()``) at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, field 22 of stat
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def card_info(torch) -> Dict:
    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["nvidia_smi"] = "unavailable"
    return info


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``pixparse_tpu_torch`` is not ``pixparse_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
