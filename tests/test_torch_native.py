"""The port's native data-plane binding (``pixparse_tpu_torch/native``)
against PIL and the JAX package's binding of the same C++ source.

The library is built at first use (the first test that needs it), into
``pixparse_tpu_torch/csrc/build/``, under a cross-process lock: the xdist
workers that reach it together build it once. The JAX binding is pointed at
the port's build of the same source and flags (its own ``make`` has no lock
across processes), so both sides run the same decoder and resizers and the
comparisons hold the Python around them.
"""

import ctypes
import importlib.util
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import pixparse_tpu.native as jnative
from pixparse_tpu.data import transforms as jtransforms
from pixparse_tpu.data import wds as jwds
from pixparse_tpu.ops import pix2struct as jops
from pixparse_tpu_torch import native
from pixparse_tpu_torch.data import transforms as ttransforms
from pixparse_tpu_torch.data import wds as twds
from pixparse_tpu_torch.ops import pix2struct as tops

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def lib():
    """The port's library, built here at first use (this host has g++,
    libjpeg and libpng)."""
    out = native.load_native()
    assert out is not None, native.build_error()
    return out


@pytest.fixture
def jax_on_port_lib(lib, monkeypatch):
    """The JAX binding loads the port's build of the same source."""
    monkeypatch.setattr(jnative, "_lib", jnative._configure(ctypes.CDLL(str(native.lib_path()))))


def _gray_image(h=200, w=160, seed=0):
    rng = np.random.RandomState(seed)
    base = np.full((h, w), 235, np.uint8)
    for y in range(10, h, 20):
        base[y:y + 2, 10:-10] = rng.randint(0, 80)
    return base


def _encoded(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


def test_png_decode_exact(lib):
    for arr, gray in ((_gray_image(), True),
                      (np.random.RandomState(1).randint(0, 256, (37, 53, 3), np.uint8), False)):
        out = native.decode_image(_encoded(arr, "PNG"), gray=gray)
        np.testing.assert_array_equal(out, arr[:, :, None] if gray else arr)


@pytest.mark.parametrize("target,shape", [
    (None, (200, 160)), ((100, 80), (100, 80)), ((50, 40), (50, 40)), ((25, 20), (25, 20)),
    ((26, 20), (50, 40)), ((300, 80), (200, 160)),
])
def test_jpeg_decode_close_to_pil_and_dct_scaled(lib, target, shape):
    arr = _gray_image()
    data = _encoded(arr, "JPEG", quality=95)
    out = native.decode_image(data, gray=True, target_size=target)
    assert out.shape == (*shape, 1)
    pil = Image.open(io.BytesIO(data))
    pil.draft("L", (shape[1], shape[0]))  # PIL's own DCT-scaled decode
    pil = np.asarray(pil.convert("L"))
    assert pil.shape == shape
    assert np.abs(out[:, :, 0].astype(int) - pil.astype(int)).mean() < 2.0


def test_jpeg_gray_source_rgb_request_gives_3_channels(lib):
    out = native.decode_image(_encoded(_gray_image(), "JPEG", quality=95), gray=False)
    assert out.shape == (200, 160, 3)


def test_undecodable_bytes_give_none(lib):
    assert native.decode_image(b"GIF89a" + bytes(20)) is None
    assert native.decode_image(b"\xff\xd8" + bytes(20)) is None  # a JPEG magic, no JPEG
    assert native.decode_image(b"\x89PNG" + bytes(20)) is None


@pytest.mark.parametrize("full,target,want", [
    ((2000, 1600), (576, 448), 2), ((4800, 3600), (576, 448), 8), ((600, 500), (576, 448), 1),
    ((2200, 1700), (576, 448), 2), ((1152, 896), (576, 448), 2), ((1151, 896), (576, 448), 1),
])
def test_choose_jpeg_scale_equals_jax(full, target, want):
    assert native.choose_jpeg_scale(*full, *target) == jnative.choose_jpeg_scale(*full, *target)
    assert native.choose_jpeg_scale(*full, *target) == want


@pytest.mark.parametrize("src,dst,interp", [
    ((640, 500, 1), (576, 445), "bicubic"),
    ((640, 500, 1), (576, 445), "bilinear"),
    ((1650, 1275, 1), (576, 445), "bicubic"),
    ((200, 300, 1), (576, 445), "bicubic"),
    ((240, 100, 3), (60, 200), "bicubic"),
    ((240, 100, 3), (60, 200), "bilinear"),
    ((5, 7, 1), (3, 2), "bicubic"),
    ((2, 2, 1), (9, 9), "bilinear"),
    ((300, 200, 1), (300, 120), "bicubic"),
    ((300, 200, 1), (120, 200), "bicubic"),
    ((2200, 1700, 1), (576, 448), "bicubic"),
])
def test_resize_filter_bit_exact_with_pil(lib, src, dst, interp):
    x = np.random.RandomState(sum(src)).randint(0, 256, src, np.uint8)
    x2 = x[:, :, 0] if src[2] == 1 else x
    flag = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[interp]
    ref = np.asarray(Image.fromarray(x2).resize((dst[1], dst[0]), flag))
    np.testing.assert_array_equal(native.resize_filter(x2, dst, interp), ref)


def test_resize_filter_document_structure_exact(lib):
    doc = np.full((660, 510), 255, np.uint8)
    doc[::7, :] = 0
    doc[:, ::11] = 30
    ref = np.asarray(Image.fromarray(doc).resize((445, 576), Image.BICUBIC))
    np.testing.assert_array_equal(native.resize_filter(doc, (576, 445), "bicubic"), ref)


def test_resize_filter_falls_back_where_jax_does(lib):
    assert native.resize_filter(np.zeros((8, 8), np.float32), (4, 4)) is None
    assert native.resize_filter(np.zeros((8, 8), np.uint8), (4, 4), "lanczos") is None
    assert native.resize_filter(np.zeros((8, 8), np.uint8), (4, 4), "bilinear").shape == (4, 4)


@pytest.mark.parametrize("size", [(64, 48), (576, 448), (301, 7)])
def test_resize_bilinear_within_one_grey_level_of_pil(lib, size):
    arr = np.random.RandomState(0).randint(0, 255, (300, 220), np.uint8)
    ours = native.resize_bilinear(arr[:, :, None], size)[:, :, 0]
    pil = np.asarray(Image.fromarray(arr, "L").resize((size[1], size[0]), Image.BILINEAR))
    assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 1


def test_resize_pad_normalize_equals_jax(jax_on_port_lib):
    arr = _gray_image()
    args = ((128, 100), (120, 96), (0.5,), (0.5,))
    out = native.resize_pad_normalize(arr[:, :, None], *args)
    np.testing.assert_array_equal(out, jnative.resize_pad_normalize(arr[:, :, None], *args))
    np.testing.assert_allclose(out[125, 98, 0], 1.0, atol=1e-5)  # the fill, normalized
    rgb = np.random.RandomState(2).randint(0, 256, (50, 40, 3), np.uint8)
    np.testing.assert_array_equal(
        native.resize_pad_normalize(rgb, (32, 32), (30, 24), 0.5, 0.25),
        jnative.resize_pad_normalize(rgb, (32, 32), (30, 24), 0.5, 0.25))


@pytest.mark.parametrize("ext,fmt,target", [
    ("png", "L", None), ("png", "RGB", None), ("jpg", "L", None), ("jpg", "L", (50, 40)),
    ("jpeg", "RGB", (100, 80)),
])
def test_decode_image_bytes_equals_jax_and_goes_native(jax_on_port_lib, ext, fmt, target):
    data = _encoded(_gray_image(), "PNG" if ext == "png" else "JPEG", quality=90)
    native.reset_calls()
    got = twds.decode_image_bytes(data, ext, fmt, target_size=target)
    want = jwds.decode_image_bytes(data, ext, fmt, target_size=target)
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert native.decode_image.calls == 1


def test_decode_image_bytes_without_the_library_takes_pil(monkeypatch):
    """No library: PIL decodes, a JPEG DCT-scaled through its ``draft``."""
    monkeypatch.setattr(twds, "decode_image", lambda *a, **k: None)
    data = _encoded(_gray_image(400, 320), "JPEG", quality=90)
    img = twds.decode_image_bytes(data, "jpg", "L", target_size=(100, 80))
    assert isinstance(img, Image.Image) and img.size == (80, 100)  # 1/4
    png = twds.decode_image_bytes(_encoded(_gray_image(), "PNG"), "png", "L")
    np.testing.assert_array_equal(np.asarray(png), _gray_image())


@pytest.mark.parametrize("shape,size,interp", [
    ((300, 220), (120, 90), "bicubic"), ((300, 220, 3), (64, 48), "bilinear"),
    ((64, 48), (64, 48), "bicubic"), ((40, 30), (120, 90), "bicubic"),
])
def test_transforms_resize_equals_jax_and_goes_native(jax_on_port_lib, shape, size, interp):
    x = np.random.RandomState(3).randint(0, 256, shape, np.uint8)
    native.reset_calls()
    got = ttransforms._resize(x, size, interp)
    np.testing.assert_array_equal(got, jtransforms._resize(x, size, interp))
    assert native.resize_filter.calls == 1


def test_legacy_runs_without_pil(lib, monkeypatch):
    """The card machine has no PIL: decode and the legacy transform need none."""
    png = _encoded(_gray_image(), "PNG")
    jpg = _encoded(_gray_image(), "JPEG", quality=90)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for norm in (True, False):
        tf = ttransforms.create_transforms("legacy", (64, 48), training=True, normalize=norm)
        for data, ext in ((png, "png"), (jpg, "jpg")):
            out = tf(twds.decode_image_bytes(data, ext, "L", target_size=(64, 48)))
            assert out.shape == (64, 48, 1) and out.dtype == (np.float32 if norm else np.uint8)


@pytest.mark.parametrize("shape", [(300, 200), (90, 140, 3), (4000, 30), (45, 4)])
def test_patchify_variable_equals_jax_on_the_native_resize(jax_on_port_lib, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 255, shape).astype(np.uint8)
    c = 1 if len(shape) == 2 else shape[2]
    kw = dict(mean=(0.5,) * c, std=(0.5,) * c)
    native.reset_calls()
    got = tops.patchify_variable(img, 16, 256, **kw)
    assert native.resize_bilinear.calls == 1
    want = jops.patchify_variable(img, 16, 256, **kw)
    for k in ("patches", "rows", "cols", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_call_counters_lose_no_update_under_threads(lib):
    """The loader's threads bump the counters together: 16 threads (more
    than this host's cores), a short switch interval, every call counted."""
    import threading

    data = _encoded(_gray_image(20, 16), "PNG")
    native.reset_calls()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [native.decode_image(data) for _ in range(200)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert native.decode_image.calls == 16 * 200


_RACE = """
import subprocess, sys, time
from pathlib import Path
import pixparse_tpu_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
runs = []
real_run = subprocess.run
def counted(cmd, *a, **k):
    runs.append(cmd[0])
    return real_run(cmd, *a, **k)
subprocess.run = counted
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
lib = n.load_native()
print(lib is not None, n.lib_path().name, len(runs), n.build_error())
"""


def test_processes_that_build_at_once_build_one_library(tmp_path):
    """4 processes start the first build together: one compiles, under the
    lock; all 4 load the same finished file; no temporary file is left."""
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path), str(start)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert all(line[0] == "True" for line in lines), outs
    assert len({line[1] for line in lines}) == 1
    assert sum(int(line[2]) for line in lines) == 1  # one compiler run in all
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".so") == [lines[0][1]]
    assert not list(tmp_path.glob("*.tmp"))


def test_a_missing_header_is_named_and_nothing_loads(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header_for_this_test.h>\nextern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_attempted", False)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.load_native() is None and not native.native_available()
    assert native.decode_image(_encoded(_gray_image(), "PNG")) is None
    assert "no_such_header_for_this_test.h" in native.build_error()
    cs = _chip_smoke()
    assert cs.native_skip_reason(native.build_error()) == "no_such_header_for_this_test.h"
    assert cs.native_skip_reason("/usr/bin/ld: cannot find -ljpeg: No such file") == "-ljpeg"
    assert cs.native_skip_reason("error: expected ';'") is None
    assert not list((tmp_path / "build").glob("*.so"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_png_writer_of_chip_smoke_round_trips(lib):
    cs = _chip_smoke()
    page = np.random.RandomState(4).randint(0, 256, (33, 21), np.uint8)
    data = cs.png_bytes(page)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), page)
    np.testing.assert_array_equal(native.decode_image(data)[:, :, 0], page)


def test_page_fixtures_are_the_tools_pages():
    """The committed JPEG fixtures decode to the tool's seeded pages (JPEG
    quality 90: a small mean error), within the size they were made for."""
    from pixparse_tpu_torch.tools import make_page_fixtures as mpf

    files = sorted(mpf.FIXTURE_DIR.glob("page_*.jpg"))
    assert len(files) == mpf.N_PAGES
    assert sum(f.stat().st_size for f in files) < 2 * 2**20
    for i, f in enumerate(files):
        got = np.asarray(Image.open(f).convert("L")).astype(int)
        assert got.shape == mpf.PAGE_SIZE
        assert np.abs(got - mpf.synthetic_page(i).astype(int)).mean() < 2.0


def test_chip_smoke_loader_phase_on_the_cpu(lib, tmp_path, monkeypatch):
    """The ``loader`` phase at cruller_test: small PNG pages, the JPEG
    fixtures once each, two steps of app.train each way."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    with cs.nan_default_init(torch):
        counts = cs.phase_loader(torch, model_name="cruller_test", B=2, steps=3,
                                 page_size=(220, 170), n_png=4, jpeg_repeats=1, threads=(1, 2),
                                 loader_batches=2, workers=2, vocab=300, device="cpu")
    assert set(counts) == {"loader_app_train_dp0", "loader_app_train_dp1", "loader_synthetic"}
    rec = json.loads((tmp_path / "phases.jsonl").read_text().splitlines()[-1])
    assert rec["phase"] == "loader" and rec["shard"]["pages"] == 8
    assert rec["decode"]["png_exact"] == 4
    assert rec["decode"]["native_calls"] == {"decode_image": 8, "resize_filter": 8}
    assert rec["decode"]["jpeg_scaled_shape"] == [275, 213, 1]  # 1/8 of 2200x1700 for 64x48
    for run in ("app_train_dp0", "app_train_dp1"):
        r = rec["train"][run]
        assert r["rc"] == 0 and r["steps"] == 3 and r["pages_decoded"]["other"] == 0
        assert r["step1_vs_arrays"]["rel_diff"] <= 1e-3
    assert rec["train"]["synthetic"]["steps"] == 3
