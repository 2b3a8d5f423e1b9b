"""ctypes binding of the native data-plane library (counterpart of
:mod:`pixparse_tpu.native`, same names and behaviour).

The library is ``native/pixparse_native.cpp`` at the root of the checkout,
compiled as it stands (libjpeg decode with DCT scaling, libpng decode, a
PIL-exact antialiased resize, a bilinear resize and a fused resize + pad +
normalize; plain C entry points). It runs on the host: the loader's threads
call it, and ctypes releases the GIL for each call.

Build rules:

- on first use (:func:`load_native`), never at import: ``g++`` with the
  flags of ``native/Makefile`` into ``pixparse_tpu_torch/csrc/build/``
  (listed in ``.gitignore``), never into ``native/``;
- the file name carries a hash of the source, the flags and the host CPU
  (``-march=native`` code is built for the machine that runs it);
- the build holds an ``fcntl.flock`` on a lock file beside the library,
  writes to a temporary name and ``os.replace``-s it, so processes that
  start their first use together build once and never load a half-written
  file.

Every entry point returns ``None`` where the JAX module's does (no library,
an unsupported input, a decode error), and the caller falls back. When the
build fails, :func:`build_error` gives the compiler's message. Each entry
point counts, in ``.calls``, the calls the library answered, so a run can
show which path decoded and resized its pages.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pixparse_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-ljpeg", "-lpng", "-lz"]

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False
_build_error: Optional[str] = None
_count_lock = threading.Lock()


def _cpu_signature() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native`` reads)."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [l for l in fh if l.startswith(("model name", "flags"))][:2]
        return "".join(lines).encode()
    except OSError:
        return platform.processor().encode()


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_cpu_signature())
    return BUILD_DIR / f"libpixparse_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the library into ``out`` unless another process already has;
    raises ``RuntimeError`` with the compiler's message when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"{cmd[0]}: {e}") from e
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _configure(lib):
    i8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    I, I64 = ctypes.c_int, ctypes.c_int64
    signatures = {
        "jpeg_probe": [i8p, I64, I, I, i32p, i32p, i32p],
        "jpeg_decode": [i8p, I64, I, I, i8p, I, I, I],
        "png_probe": [i8p, I64, I, i32p, i32p, i32p],
        "png_decode": [i8p, I64, I, i8p, I, I, I],
        "resize_bilinear_u8": [i8p, I, I, I, i8p, I, I],
        "resize_filter_u8": [i8p, I, I, I, i8p, I, I, I],
        "resize_pad_normalize_f32": [i8p, I, I, I, f32p, I, I, I, I, f32p, f32p, I],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_native():
    """Load (building it first if needed) the native library; None when it
    cannot be built or loaded (:func:`build_error` says why)."""
    global _lib, _build_attempted, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        try:
            out = lib_path()
            _build(out)
            _lib = _configure(ctypes.CDLL(str(out)))
        except (RuntimeError, OSError, AttributeError) as e:
            _build_error = str(e)
    return _lib


def build_error() -> Optional[str]:
    """Why :func:`load_native` returned None (the compiler's or loader's
    message), or None."""
    return _build_error


def native_available() -> bool:
    return load_native() is not None


def _counted(fn):
    fn.calls = 0
    return fn


def _count(fn) -> None:
    with _count_lock:
        fn.calls += 1


def reset_calls() -> None:
    for fn in (decode_image, resize_bilinear, resize_filter, resize_pad_normalize):
        fn.calls = 0


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG"


def choose_jpeg_scale(full_h: int, full_w: int, target_h: int, target_w: int) -> int:
    """Largest libjpeg scale_denom in {1,2,4,8} keeping the decode >= target."""
    denom = 1
    for d in (2, 4, 8):
        if full_h // d >= target_h and full_w // d >= target_w:
            denom = d
    return denom


@_counted
def decode_image(
    data: bytes,
    gray: bool = True,
    target_size: Optional[Tuple[int, int]] = None,
) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes -> (H, W, C) uint8; None -> the caller falls
    back. JPEGs with a ``target_size`` decode DCT-scaled (1/2..1/8)."""
    lib = load_native()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    dims = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    want_gray = 1 if gray else 0
    if data[:2] == _JPEG_MAGIC:
        if lib.jpeg_probe(_u8p(buf), len(data), 1, want_gray, *dims):
            return None
        denom = 1
        if target_size is not None:
            denom = choose_jpeg_scale(h.value, w.value, *target_size)
        if denom != 1 and lib.jpeg_probe(_u8p(buf), len(data), denom, want_gray, *dims):
            return None
        out = np.empty((h.value, w.value, c.value), np.uint8)
        if lib.jpeg_decode(_u8p(buf), len(data), denom, want_gray,
                           _u8p(out), h.value, w.value, c.value):
            return None
    elif data[:4] == _PNG_MAGIC:
        if lib.png_probe(_u8p(buf), len(data), want_gray, *dims):
            return None
        out = np.empty((h.value, w.value, c.value), np.uint8)
        if lib.png_decode(_u8p(buf), len(data), want_gray,
                          _u8p(out), h.value, w.value, c.value):
            return None
    else:
        return None
    _count(decode_image)
    return out


@_counted
def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """(H, W, C) uint8 -> (h, w, C) uint8 bilinear (within 1 grey level of
    PIL's); None -> fallback."""
    lib = load_native()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    dh, dw = size
    out = np.empty((dh, dw, img.shape[2]), np.uint8)
    if lib.resize_bilinear_u8(_u8p(img), img.shape[0], img.shape[1], img.shape[2],
                              _u8p(out), dh, dw):
        return None
    _count(resize_bilinear)
    return out


_FILTER_IDS = {"bilinear": 0, "bicubic": 1}


@_counted
def resize_filter(
    img: np.ndarray, size: Tuple[int, int], interpolation: str = "bicubic"
) -> Optional[np.ndarray]:
    """PIL's antialiased resize (bilinear/bicubic), bit for bit: uint8
    (H, W[, C]) -> (h, w[, C]) uint8 (PIL's taps, fixed-point coefficients,
    pass order and uint8 intermediate). 2D in -> 2D out. None -> the caller
    falls back to PIL (other filters or dtypes, no library)."""
    fid = _FILTER_IDS.get(interpolation)
    if fid is None or img.dtype != np.uint8:
        return None
    lib = load_native()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    img = np.ascontiguousarray(img, np.uint8)
    if squeeze:
        img = img[:, :, None]
    if img.ndim != 3:
        return None
    dh, dw = size
    out = np.empty((dh, dw, img.shape[2]), np.uint8)
    if lib.resize_filter_u8(_u8p(img), img.shape[0], img.shape[1], img.shape[2],
                            _u8p(out), dh, dw, fid):
        return None
    _count(resize_filter)
    return out[:, :, 0] if squeeze else out


@_counted
def resize_pad_normalize(
    img: np.ndarray,
    canvas: Tuple[int, int],
    resized: Tuple[int, int],
    mean,
    std,
    fill: int = 255,
) -> Optional[np.ndarray]:
    """Fused path: uint8 (H, W, C) -> float32 (th, tw, C) normalized, the
    image resized (bilinear) to ``resized`` in the top-left, the rest
    ``fill``."""
    lib = load_native()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    th, tw = canvas
    rh, rw = resized
    mean_a = np.asarray(mean, np.float32).reshape(-1)
    std_a = np.asarray(std, np.float32).reshape(-1)
    if mean_a.size == 1 and c > 1:
        mean_a = np.repeat(mean_a, c)
        std_a = np.repeat(std_a, c)
    out = np.empty((th, tw, c), np.float32)
    if lib.resize_pad_normalize_f32(_u8p(img), img.shape[0], img.shape[1], c,
                                    _f32p(out), th, tw, rh, rw,
                                    _f32p(mean_a), _f32p(std_a), fill):
        return None
    _count(resize_pad_normalize)
    return out
