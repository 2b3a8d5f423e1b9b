"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and the port only (no JAX), so it runs on a CUDA
machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a card the ``cuda``-marked tests skip: a CUDA kernel has no CPU
mode. chip_smoke.py holds the same kernels against the same plain versions
at the serving path's shapes. The unmarked tests check the host-side pieces
around the kernels (the build cache key, the decode split plan, the flash
wrapper's layout check), which run anywhere.
"""

import pytest
import torch

from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_q8,
    decode_attention_q8_plain,
    decode_plan,
    DECODE_MAX_SPLIT_KEYS,
    DECODE_TILE_BYTES,
    quantize_kv_rows,
)
from pixparse_tpu_torch.ops.flash_attention import (
    DEAD_LSE,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from pixparse_tpu_torch.ops import flash_attention as flash_ops
from pixparse_tpu_torch.ops.generation import q8_logits, quantize_head
from pixparse_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_plain,
    layer_norm_fwd,
    layer_norm_fwd_plain,
)
from pixparse_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_plain,
)
from pixparse_tpu_torch.ops.loss import (
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_ce_fwd,
    fused_ce_fwd_plain,
    fused_cross_entropy_from_hidden,
)
from pixparse_tpu_torch.tools.mxu_probe import mxu_dots, mxu_dots_plain, operands
from pixparse_tpu_torch.tools.window_band_probe import banded_attention, banded_attention_plain

# bf16: inputs and outputs round to 8 mantissa bits, and the kernel sums in
# another order than the plain version; fp32: summation order only
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def test_build_cache_key_follows_source_and_flags(monkeypatch):
    path = _build._lib_path("flash_attention")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_attention-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._lib_path("flash_attention") != path
    assert set(_build.SIGNATURES) == {p.stem for p in _build.CSRC.glob("*.cu")}


def test_build_cache_key_follows_headers(monkeypatch, tmp_path):
    """A library that includes a shared header is rebuilt when the header
    changes: every csrc/*.cuh is part of each library's file name."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = {stem: _build._lib_path(stem).name for stem in _build.SIGNATURES}
    with open(headers[0], "a") as fh:
        fh.write("// edited\n")
    after = {stem: _build._lib_path(stem).name for stem in _build.SIGNATURES}
    assert all(before[stem] != after[stem] for stem in before)


@pytest.mark.parametrize(
    "B,Lk,row_bytes,want",
    [
        (16, 1024, 1536, (10, 70, 15)),  # cruller_base's cross cache, H*D = 768
        (16, 128, 1536, (10, 10, 13)),  # its self cache: one tile a split
        (16, 64, 1536, (10, 10, 7)),
        (1, 1024, 1536, (10, 10, 103)),  # one sample: many short splits
        (333, 1024, 1536, (10, 1030, 1)),  # more samples than two per SM: one split
        (16, 1, 1536, (10, 10, 1)),  # one key
        (8, 4864, 2048, (8, 152, 32)),  # donut_base's cross cache, H*D = 1024
        (3, 256, 128, (64, 64, 4)),  # H*D = 64: the tile stops at 64 keys
        (4, 384, 3072, (5, 10, 39)),  # fp32
        (1, 32768, 1536, (10, 130, 253)),
        (16, 0, 1536, (10, 10, 1)),  # an empty cache still launches one split
    ],
)
def test_decode_plan(B, Lk, row_bytes, want):
    """About two blocks per SM on a 132-SM card; splits of whole key tiles
    of at most DECODE_TILE_BYTES that together cover the cache."""
    kt, split, n_split = decode_plan(B, Lk, row_bytes, 132)
    assert (kt, split, n_split) == want
    assert split % kt == 0 and split <= DECODE_MAX_SPLIT_KEYS
    assert kt * row_bytes <= DECODE_TILE_BYTES
    assert (n_split - 1) * split < max(Lk, 1) <= n_split * split


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda_device, dtype, D, causal):
    gen = torch.Generator().manual_seed(D)
    B, L, H = 3, 133, 4
    # q/k/v as strided views of one fused projection, as the ViT passes them
    qkv = torch.randn(B, L, 3, H, D, generator=gen).to(cuda_device, dtype)
    q, k, v = qkv.unbind(2)
    lens = torch.tensor([133, 0, 70], dtype=torch.int32, device=cuda_device)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal, kv_lens=lens)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
    assert (o[1] == 0).all() and (lse[1] == DEAD_LSE).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk", [(100, 300), (2509, 2509), (1, 77)])
def test_flash_kernel_ragged_and_multi_tile(cuda_device, Lq, Lk):
    gen = torch.Generator().manual_seed(Lq)
    q = torch.randn(2, Lq, 2, 64, generator=gen).to(cuda_device, torch.bfloat16)
    k, v = (torch.randn(2, Lk, 2, 64, generator=gen).to(cuda_device, torch.bfloat16)
            for _ in range(2))
    for causal in (False, True):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,causal", [
    (1009, 1009, False), (1023, 1023, True), (1023, 1009, False),
])
def test_flash_kernel_train_step_lengths(cuda_device, Lq, Lk, causal):
    """The three sites of a cruller_base train step: encoder, causal decoder
    self-attention, decoder cross-attention; every tail is ragged."""
    q, k, v, _ = _bwd_inputs(2, Lq, Lk, 12, 64, torch.bfloat16, cuda_device, Lq + Lk)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, lse_ref, **LSE_TOL)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 2, 48, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_decode_kernel_matches_plain(cuda_device, dtype, D):
    gen = torch.Generator().manual_seed(D)
    B, Lk, H = 4, 384, 768 // D
    q = torch.randn(B, 1, H * D, generator=gen).to(cuda_device, dtype)
    k = torch.randn(B, Lk, H * D, generator=gen).to(cuda_device, dtype)
    v = torch.randn(B, Lk, H * D, generator=gen).to(cuda_device, dtype)
    mask = torch.rand(B, Lk, generator=gen) > 0.3
    mask[1] = False  # a dead row
    mask[2, 200:] = False  # a short prefix: nothing past it is read
    mask = mask.to(cuda_device)
    before = decode_attention.launches
    o = decode_attention(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, k, v, mask, num_heads=H)
    torch.testing.assert_close(o.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert (o[1] == 0).all()
    assert torch.equal(decode_attention(q, k, v, mask, num_heads=H), o)  # fixed-order merge


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(32, 8), (64, 16), (128, 6)])
@pytest.mark.parametrize("whole_tiles", [0, 7])
def test_decode_kernel_ragged_masks_and_partial_tiles(cuda_device, D, H, whole_tiles):
    """Lk below one key tile, or whole tiles and a partial one (never a
    multiple of the tile); masks with holes, a dead row, a short prefix,
    only the first or only the last key: within the plain version's
    tolerance, dead rows exactly 0, a second launch bit-identical."""
    kt, _, _ = decode_plan(1, 1, H * D * 2, 132)
    Lk = whole_tiles * kt + kt // 2 + 1
    B = 7
    gen = torch.Generator().manual_seed(Lk + D)
    q = torch.randn(B, 1, H * D, generator=gen).to(cuda_device, torch.bfloat16)
    k = torch.randn(B, Lk, H * D, generator=gen).to(cuda_device, torch.bfloat16)
    v = torch.randn(B, Lk, H * D, generator=gen).to(cuda_device, torch.bfloat16)
    mask = torch.rand(B, Lk, generator=gen) > 0.25  # holes
    mask[1] = False  # dead row
    mask[2, Lk // 2 + 1:] = False  # a short prefix
    mask[3] = True
    mask[4] = False
    mask[4, 0] = True  # only the first key
    mask[5] = False
    mask[5, -1] = True  # only the last key
    mask = mask.to(cuda_device)
    o = decode_attention(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, mask, num_heads=H)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    assert (o[1] == 0).all()
    assert torch.equal(decode_attention(q, k, v, mask, num_heads=H), o)


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 1, 96, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 96, device=cuda_device, dtype=torch.bfloat16)
    mask = torch.ones(2, 16, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, k, k, mask, num_heads=2)
    with pytest.raises(ValueError, match="mask shape"):
        decode_attention(q, k, k, mask[:, :8], num_heads=3)
    # a key tile is one contiguous run of rows: strided caches are refused,
    # not copied
    wide = torch.zeros(2, 16, 192, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous rows"):
        decode_attention(q, wide[:, :, :96], k, mask, num_heads=3)
    with pytest.raises(ValueError, match="contiguous rows"):
        decode_attention(q, k, wide[:, :, 96:], mask, num_heads=3)


def _bwd_inputs(B, Lq, Lk, H, D, dtype, device, seed, fused=True):
    gen = torch.Generator().manual_seed(seed)
    if fused and Lq == Lk:
        q, k, v = torch.randn(B, Lq, 3, H, D, generator=gen).to(device, dtype).unbind(2)
    else:
        q = torch.randn(B, Lq, H, D, generator=gen).to(device, dtype)
        k, v = torch.randn(B, Lk, 2, H, D, generator=gen).to(device, dtype).unbind(2)
    do = torch.randn(B, Lq, H, D, generator=gen).to(device, dtype)
    return q, k, v, do


def _check_flash_bwd(q, k, v, do, causal, lens, tol):
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, do, lse, delta, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal, kv_lens=lens)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous(), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=lambda m: f"{name}: {m}")
        # and head by head: the L2 error of every (token, head) row within
        # tol of its norm, rows under 1% of the mean norm held to that floor
        err = (a.float() - b.float()).norm(dim=-1)
        norm = b.float().norm(dim=-1)
        assert (err <= tol * norm.clamp_min(1e-2 * norm.mean())).all(), name
    return got


# bf16 gradients sum up to a thousand rounded products per element in another
# order than the plain version; fp32 differs by summation order only
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernel_matches_plain(cuda_device, dtype, D, causal):
    q, k, v, do = _bwd_inputs(3, 133, 133, 4, D, dtype, cuda_device, D)
    lens = torch.tensor([133, 0, 70], dtype=torch.int32, device=cuda_device)
    dq, dk, dv = _check_flash_bwd(q, k, v, do, causal, lens, BWD_TOL[dtype])
    # the sample with no valid key: p = 0 everywhere, so all three vanish
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dk[2, 70:] == 0).all() and (dv[2, 70:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,causal", [
    (1023, 1023, True), (1023, 1009, False), (1009, 1009, False),
    (100, 300, True), (300, 100, True), (2509, 2509, False), (1, 77, False),
])
def test_flash_bwd_kernel_ragged_and_multi_tile(cuda_device, Lq, Lk, causal):
    q, k, v, do = _bwd_inputs(2, Lq, Lk, 2, 64, torch.bfloat16, cuda_device, Lq)
    _check_flash_bwd(q, k, v, do, causal, None, BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda_device):
    """Gradients of the autograd Function (both kernels) against autograd
    through the plain forward."""
    q, k, v, do = _bwd_inputs(2, 200, 200, 4, 64, torch.float32, cuda_device, 7)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=True).backward(do)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*refs, causal=True)[0].backward(do)
    for a, b in zip(leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, atol=2e-4, rtol=2e-4)


# Tile edges of the wgmma kernels: forward blocks of 128 query rows (two
# warpgroups of 64) over key tiles of 128; backward blocks of 128 rows over
# streamed tiles of 64. Lengths on and either side of 64 and 128.
EDGE_LENGTHS = [(1, 1), (63, 63), (65, 65), (127, 127), (129, 129), (1, 129), (129, 1),
                (63, 129), (65, 127), (127, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("Lq,Lk", EDGE_LENGTHS)
def test_flash_kernels_at_tile_edges(cuda_device, D, Lq, Lk):
    """Forward and backward, bf16, both masks off and causal; q/k/v as
    strided views of one fused projection (row stride 3*H*D) where Lq == Lk."""
    q, k, v, do = _bwd_inputs(2, Lq, Lk, 3, D, torch.bfloat16, cuda_device, 97 * Lq + Lk)
    for causal in (False, True):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        if Lk > 1:
            _check_flash_bwd(q, k, v, do, causal, None, BWD_TOL[torch.bfloat16])
            continue
        # one key: p = 1 wherever it is visible, dv = do there, and the true
        # dq, dk are 0 (both versions leave only cancellation noise)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta, causal=causal)
        _, _, dv_ref = flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal)
        torch.testing.assert_close(dv.float(), dv_ref.float(), atol=1e-2, rtol=1e-2)
        scale = float(do.float().abs().max() * v.float().abs().max())
        assert float(dq.float().abs().max()) <= 1e-3 * scale
        assert float(dk.float().abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernels_strided_qkv_ragged_1009(cuda_device, D):
    """The ViT's operands: views of a fused (B, L, 3, H, D) projection, L =
    1009 ragged against every tile, plus kv_lens ending exactly on a 128-key
    tile boundary, one past it, and 0 (o = 0, lse = -1e30, zero gradients)."""
    q, k, v, do = _bwd_inputs(4, 1009, 1009, 2, D, torch.bfloat16, cuda_device, D + 1)
    assert q.stride(1) == 3 * 2 * D
    for lens in (None, [128, 129, 0, 1009]):
        kl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        o, lse = flash_attention_fwd(q, k, v, kv_lens=kl)
        o_ref, lse_ref = flash_attention_plain(q, k, v, kv_lens=kl)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        dq, dk, dv = _check_flash_bwd(q, k, v, do, False, kl, BWD_TOL[torch.bfloat16])
        if lens is not None:
            assert (o[2] == 0).all() and (lse[2] == DEAD_LSE).all()
            assert (dq[2] == 0).all() and (dk[2] == 0).all() and (dv[2] == 0).all()
            assert (dk[0, 128:] == 0).all() and (dv[1, 129:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk", [(100, 200), (64, 300), (129, 257)])
def test_flash_kernels_causal_lq_below_lk(cuda_device, Lq, Lk):
    """Bottom-right causal with Lq < Lk: each row's last visible key crosses
    a 128-key tile boundary."""
    q, k, v, do = _bwd_inputs(2, Lq, Lk, 2, 64, torch.bfloat16, cuda_device, Lq * Lk)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
    _check_flash_bwd(q, k, v, do, True, None, BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernels_refuse_strides_tma_cannot_take(cuda_device):
    q = torch.zeros(2, 16, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    padded = torch.zeros(2, 16, 2 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
    k = padded[..., : 2 * 64].unflatten(-1, (2, 64))  # row stride 132 elements
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(q, k, q)
    lse = torch.zeros(2, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_bwd(q, k, q, q, lse, lse)
    flat = torch.zeros(2 * 16 * 2 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
    shifted = flat[4:].view(2, 16, 2, 64)  # base 8 bytes past alignment
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(shifted, q, q)


def _layout_cases():
    base = torch.zeros(2 * 16 * 3 * 2 * 64 + 64, dtype=torch.bfloat16)
    qkv = base[: 2 * 16 * 3 * 2 * 64].view(2, 16, 3, 2, 64)
    padded = base[: 2 * 16 * 132].view(2, 16, 132)[..., :128].unflatten(-1, (2, 64))
    return {
        "contiguous": (torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16), True),
        "qkv_view_row_stride_3HD": (qkv[:, :, 1], True),
        "row_stride_8_bytes_off": (padded, False),
        "base_8_bytes_off": (base[4 : 4 + 2 * 16 * 128].view(2, 16, 2, 64), False),
        "batch_stride_zero": (torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16).expand(2, -1, -1, -1), False),
        "row_stride_zero": (torch.zeros(2, 1, 2, 64, dtype=torch.bfloat16).expand(-1, 16, -1, -1), False),
        "single_row_any_stride": (padded[:, :1], True),
        "heads_not_contiguous": (torch.zeros(2, 16, 64, 2, dtype=torch.bfloat16).transpose(2, 3), False),
        "fp32_row_stride_4_bytes_off": (torch.zeros(2, 16, 129, dtype=torch.float32)[..., :128].unflatten(-1, (2, 64)), False),
    }


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_flash_layout_check_matches_what_tma_takes(case):
    """The wrapper's layout check (host side, runs anywhere): TMA needs a
    16-byte aligned base and row/batch strides that are positive multiples
    of 16 bytes; (H, D) must be contiguous."""
    t, ok = _layout_cases()[case]
    assert flash_ops._operand_ok(t) == ok
    if not ok:
        with pytest.raises(ValueError, match="16-byte aligned base"):
            flash_ops._check_operand("q", t)


def _ce_inputs(T, V, D, dtype, device, seed, ignore_every=5):
    gen = torch.Generator().manual_seed(seed)
    h = (torch.randn(T, D, generator=gen) * 0.5).to(device, dtype)
    e = (torch.randn(V, D, generator=gen) * 0.2).to(device, dtype)
    target = torch.randint(0, V, (T,), generator=gen)
    if ignore_every:
        target[::ignore_every] = -1
    return h, e, target.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,D,dtype", [
    (300, 1000, 64, torch.bfloat16), (77, 517, 64, torch.bfloat16),
    (1000, 5001, 768, torch.bfloat16), (130, 333, 768, torch.bfloat16),
    (700, 3001, 1024, torch.bfloat16), (65, 129, 1024, torch.bfloat16),
    (50, 301, 64, torch.float32), (33, 200, 768, torch.float32),
])
def test_fused_ce_kernels_match_plain(cuda_device, T, V, D, dtype):
    h, e, target = _ce_inputs(T, V, D, dtype, cuda_device, T)
    before = fused_ce_fwd.launches, fused_ce_bwd.launches
    lse, tgt = fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    lse_ref, tgt_ref = fused_ce_fwd_plain(h, e, target)
    # fp32 accumulation in another order; tgt is one bf16-input dot product
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(tgt, tgt_ref, atol=1e-3, rtol=1e-4)
    assert (tgt[target < 0] == 0).all()
    coef = torch.where(target >= 0, 1.0 / T, 0.0).to(cuda_device)
    dh, de = fused_ce_bwd(h, e, target, lse_ref, coef)
    torch.cuda.synchronize()
    assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == (before[0] + 1, before[1] + 1)
    dh_ref, de_ref = fused_ce_bwd_plain(h, e, target, lse_ref, coef)
    # outputs round to the input dtype; g rounds to bf16 before both products
    tol = dict(atol=2e-5, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-7, rtol=1e-4)
    torch.testing.assert_close(dh.float(), dh_ref.float(), **tol)
    torch.testing.assert_close(de.float(), de_ref.float(), **tol)
    assert (dh[target < 0] == 0).all()


def _ce_bwd_edge_cases():
    # V across the vocabulary-chunk boundary: at T = 16368 the plan's chunk is
    # 8192 rows (one full chunk + 1 row; two + 8191 rows), cheap at D = 64
    cases = [(16368, 8193, 64, 5), (16368, 16383, 64, 5)]
    for D in (64, 768, 1024):
        cases += [(T, 1000, D, 5) for T in (1, 63, 65, 129)]  # the 128-row tile's edges
        cases += [(300, 200, D, 5),  # V below one 256-row vocabulary tile
                  (129, 1000, D, 1)]  # every token ignored
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,D,ignore_every", _ce_bwd_edge_cases())
def test_fused_ce_bwd_chunks_and_edges(cuda_device, T, V, D, ignore_every):
    """The bf16 backward (three products per vocabulary chunk) at the edges of
    its tiles and chunks: within the plain version's tolerance, ignored rows
    of dh exactly 0, two calls bit-identical, its scratch returned to the
    allocator, one launch counted per call."""
    h, e, target = _ce_inputs(T, V, D, torch.bfloat16, cuda_device, T + V + D, ignore_every)
    n_valid = int((target >= 0).sum())
    lse, _ = fused_ce_fwd_plain(h, e, target)
    coef = torch.where(target >= 0, 1.0 / max(n_valid, 1), 0.0).to(cuda_device)
    before = fused_ce_bwd.launches
    dh, de = fused_ce_bwd(h, e, target, lse, coef)
    torch.cuda.synchronize()
    assert fused_ce_bwd.launches == before + 1
    dh_ref, de_ref = fused_ce_bwd_plain(h, e, target, lse, coef)
    tol = dict(atol=2e-5, rtol=2e-2)
    torch.testing.assert_close(dh.float(), dh_ref.float(), **tol)
    torch.testing.assert_close(de.float(), de_ref.float(), **tol)
    assert (dh[target < 0] == 0).all()
    if n_valid == 0:
        assert (dh == 0).all() and (de == 0).all()
    allocated = torch.cuda.memory_allocated()
    dh2, de2 = fused_ce_bwd(h, e, target, lse, coef)
    torch.cuda.synchronize()
    assert torch.equal(dh, dh2) and torch.equal(de, de2)
    del dh2, de2
    assert torch.cuda.memory_allocated() == allocated


def _ce_fwd_edge_cases():
    # T not a multiple of the 128-row tile, V not a multiple of the
    # 256-entry vocabulary tile; one token; V exactly one tile
    return [(130, 517), (300, 1000), (257, 3001), (1, 256), (77, 255)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 768, 1024])
@pytest.mark.parametrize("T,V", _ce_fwd_edge_cases())
def test_fused_ce_fwd_kernel_edges(cuda_device, D, T, V):
    """The bf16 forward (one product over the whole vocabulary, then the
    merge of its per-tile partials) at the edges of its tiles, with targets
    at columns 0, 255, 256 and V - 1 (either side of a tile boundary):
    within the plain version's tolerance, ignored rows' tgt exactly 0, a
    second launch bit-identical, the partials returned to the allocator."""
    h, e, target = _ce_inputs(T, V, D, torch.bfloat16, cuda_device, T + V + D)
    for i, col in enumerate((0, 255, 256, V - 1)):
        if 1 + i < T and col < V:
            target[1 + i] = col
    before = fused_ce_fwd.launches
    lse, tgt = fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    assert fused_ce_fwd.launches == before + 1
    lse_ref, tgt_ref = fused_ce_fwd_plain(h, e, target)
    torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
    torch.testing.assert_close(tgt, tgt_ref, **LSE_TOL)
    assert (tgt[target < 0] == 0).all()
    allocated = torch.cuda.memory_allocated()
    lse2, tgt2 = fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    assert torch.equal(lse, lse2) and torch.equal(tgt, tgt2)
    del lse2, tgt2
    assert torch.cuda.memory_allocated() == allocated


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 768, 1024])
def test_fused_ce_fwd_all_ignored_rows(cuda_device, D):
    """Every token ignored: lse is still each row's logsumexp, tgt exactly 0."""
    h, e, target = _ce_inputs(129, 1000, D, torch.bfloat16, cuda_device, D, ignore_every=1)
    lse, tgt = fused_ce_fwd(h, e, target)
    torch.cuda.synchronize()
    lse_ref, _ = fused_ce_fwd_plain(h, e, target)
    torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
    assert (tgt == 0).all()


@pytest.mark.cuda
def test_fused_ce_all_ignored_on_card(cuda_device):
    h, e, _ = _ce_inputs(64, 300, 64, torch.bfloat16, cuda_device, 3)
    h.requires_grad_()
    e.requires_grad_()
    targets = torch.full((2, 32), -100, device=cuda_device)
    loss, n = fused_cross_entropy_from_hidden(h.view(2, 32, 64), e, targets)
    loss.backward()
    assert float(loss) == 0.0 and int(n) == 0
    assert (h.grad == 0).all() and (e.grad == 0).all()


@pytest.mark.cuda
def test_fused_ce_rejects_what_it_does_not_take(cuda_device):
    h, e, target = _ce_inputs(8, 16, 48, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="widths"):
        fused_ce_fwd(h, e, target)
    with pytest.raises(ValueError, match="one dtype"):
        fused_ce_fwd(h.float(), e, target)


def _window_inputs(nB, N, H, D, dtype, device, seed, n_period=None):
    """q/k/v as column slices of one fused (nB, N, 3C) projection, as the
    Swin block passes them; bias (H, N, N) and a 0 / -1e9 shift-style mask."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(nB, N, 3 * H * D, generator=gen).to(device, dtype)
    q, k, v = qkv.split(H * D, dim=-1)
    bias = (torch.randn(H, N, N, generator=gen) * 0.5).to(device)
    mask = None
    if n_period:
        region = torch.randint(0, 3, (n_period, N), generator=gen)
        mask = torch.where(region[:, :, None] == region[:, None, :], 0.0, -1e9).to(device)
    return q, k, v, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nB,N,H,D,n_period", [
    (48, 100, 4, 32, 6),    # donut_base stage 0 widths, shifted
    (10, 100, 8, 32, None),  # unshifted
    (12, 49, 3, 16, 4),     # window 7
    (9, 16, 2, 64, 3),      # window 4 (swin_test)
    (20, 144, 2, 32, 20),   # window 12, one window per image
    (100, 49, 2, 32, 4),    # 100 items a head: not a multiple of the runs
    (1, 100, 4, 32, None),  # a single window
    (1, 100, 4, 32, 1),     # a single masked window
    (8, 144, 2, 64, 4),     # window 12 at head dim 64
    # one image per window position (B = 1, shifted): each position is read
    # by one of the forward's two units only, and runs span many positions
    (64, 100, 4, 32, 64),
    (3072, 100, 4, 32, 3072),  # donut_base stage 0 at B = 1
])
def test_window_kernel_matches_plain(cuda_device, dtype, nB, N, H, D, n_period):
    q, k, v, bias, mask = _window_inputs(nB, N, H, D, dtype, cuda_device, N + D, n_period)
    before = window_attention.launches
    o = window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    ref = window_attention_plain(q, k, v, bias, mask)
    torch.testing.assert_close(o.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_window_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, bias, mask = _window_inputs(8, 100, 4, 32, torch.bfloat16, cuda_device, 0, 4)
    with pytest.raises(ValueError, match="one dtype"):
        window_attention_bwd(q, k, v, q.float(), bias, mask)
    with pytest.raises(ValueError, match="mask period"):
        window_attention(q, k, v, bias, mask[:3])
    with pytest.raises(ValueError, match="head dim"):
        window_attention(q, k, v, bias[:1], mask)  # one head of 128
    big = _window_inputs(2, 169, 4, 32, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="tokens per window"):
        window_attention(*big)


def _rows_close(got, want, rtol, name):
    """Every row's L2 error within ``rtol`` of that row's L2 norm."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)  # rows under 1% of the mean norm: held to that floor
    assert (err <= rtol * norm.clamp_min(1e-2 * norm.mean())).all(), f"{name}: {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nB,N,H,D,n_period", [
    (48, 100, 4, 32, 6),    # donut_base stage 0 widths, shifted
    (10, 100, 8, 32, None),  # unshifted
    (12, 49, 3, 16, 4),     # window 7
    (9, 16, 2, 64, 3),      # window 4 (swin_test)
    (20, 144, 2, 32, 20),   # window 12, one window per image
    (64, 100, 2, 64, 16),   # several window positions a block
    (100, 49, 2, 32, 4),    # 100 items a head: not a multiple of the runs
    (1, 100, 4, 32, None),  # a single window
    (1, 100, 4, 32, 1),     # a single masked window
    (8, 144, 2, 64, 4),     # window 12 at head dim 64
    (64, 100, 4, 32, 64),   # one image per window position
])
def test_window_bwd_kernel_matches_plain(cuda_device, dtype, nB, N, H, D, n_period):
    q, k, v, bias, mask = _window_inputs(nB, N, H, D, dtype, cuda_device, N + D + 1, n_period)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(N)).to(cuda_device, dtype)
    before = window_attention_bwd.launches
    got = window_attention_bwd(q, k, v, do, bias, mask)
    torch.cuda.synchronize()
    assert window_attention_bwd.launches == before + 1
    want = window_attention_bwd_plain(q, k, v, do, bias, mask)
    # p and ds round to bf16 before products of up to 144 terms
    rtol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous(), name
        _rows_close(a.view(nB, N, H, D), b.view(nB, N, H, D), rtol, name)
    assert got[3].shape == (H, N, N) and got[3].dtype == torch.float32
    _rows_close(got[3], want[3], rtol, "dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("nB,N,H,D,n_period", [
    (48, 100, 4, 32, 6),    # donut_base stage 0 widths, shifted
    (10, 100, 8, 32, None),  # unshifted
    (8, 144, 2, 64, 4),     # window 12 at head dim 64
    (12, 49, 3, 16, 4),     # window 7 (odd: padded bias and mask tables)
])
def test_window_kernels_read_qkv_slices_in_place_and_repeat(cuda_device, nB, N, H, D, n_period):
    """q/k/v as column slices of one (nB, N, 3C) projection (models/swin.py)
    give the same bits as contiguous copies, and a second launch gives the
    same bits as the first, dbias included (no atomics)."""
    q, k, v, bias, mask = _window_inputs(nB, N, H, D, torch.bfloat16, cuda_device, 7, n_period)
    assert q.stride(1) == 3 * H * D and not q.is_contiguous()
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(cuda_device, q.dtype)
    copies = [t.contiguous() for t in (q, k, v)]
    o = window_attention(q, k, v, bias, mask)
    assert torch.equal(o, window_attention(q, k, v, bias, mask))
    assert torch.equal(o, window_attention(*copies, bias, mask))
    got = window_attention_bwd(q, k, v, do, bias, mask)
    again = window_attention_bwd(q, k, v, do, bias, mask)
    from_copies = window_attention_bwd(*copies, do, bias, mask)
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, again, from_copies):
        assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.cuda
def test_window_kernels_keep_bias_and_mask_in_shared_memory(cuda_device):
    """At donut_base's windows (ww 100, head dim 32) both bf16 kernels hold
    bias[h] in shared memory for the run and, with a mask, two slots of bias
    + mask; one block per SM, a ring of at least two stages."""
    from pixparse_tpu_torch.ops.window_attention import window_config

    props = torch.cuda.get_device_properties(cuda_device)
    for kind in ("fwd", "bwd"):
        for has_mask in (True, False):
            cfg = window_config(kind, torch.bfloat16, 100, 32, has_mask, cuda_device)
            want = (1, 2) if has_mask else (1, 0)
            assert (cfg["bias_in_smem"], cfg["mask_slots"]) == want, (kind, cfg)
            assert cfg["stages"] >= 2 and cfg["blocks_per_sm"] >= 1, (kind, cfg)
            assert cfg["smem_bytes"] <= getattr(props, "shared_memory_per_block_optin", 232448)


@pytest.mark.cuda
def test_window_attention_autograd_on_card(cuda_device):
    """Gradients of the autograd Function (both kernels) against autograd
    through the plain forward, fp32, the bias table's through the gather."""
    q, k, v, bias, mask = _window_inputs(24, 49, 3, 32, torch.float32, cuda_device, 5, 6)
    table = torch.randn(169, 3, device=cuda_device)
    index = torch.randint(0, 169, (49 * 49,), device=cuda_device)
    grads = []
    for fn in (window_attention, window_attention_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
        b = leaves[3].t()[:, index].reshape(3, 49, 49)
        fn(*leaves[:3], b, mask).square().sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,D", [
    (300, 128), (77, 136), (1000, 512), (300, 768), (301, 1024), (100, 2048),
    (33, 4096), (10, 8192), (3, 8),
])
def test_layer_norm_kernels_match_plain(cuda_device, dtype, R, D):
    gen = torch.Generator().manual_seed(R + D)
    x = (torch.randn(R, D, generator=gen) * 2 + 0.5).to(cuda_device, dtype)
    w = (1 + 0.3 * torch.randn(D, generator=gen)).to(cuda_device)
    b = (0.2 * torch.randn(D, generator=gen)).to(cuda_device)
    dy = torch.randn(R, D, generator=gen).to(cuda_device, dtype)
    before = layer_norm_fwd.launches, layer_norm_bwd.launches
    y = layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = layer_norm_bwd(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), layer_norm_fwd_plain(x, w, b, 1e-5).float(),
                               atol=tol, rtol=tol)
    dx_ref, dw_ref, db_ref = layer_norm_bwd_plain(x, w, dy, 1e-5)
    torch.testing.assert_close(dx.float(), dx_ref.float(), atol=tol, rtol=tol)
    # sums over R rows in another order
    torch.testing.assert_close(dw, dw_ref, atol=tol * R ** 0.5, rtol=tol)
    torch.testing.assert_close(db, db_ref, atol=tol * R ** 0.5, rtol=tol)


@pytest.mark.cuda
def test_layer_norm_opt_in_autograd_on_card(cuda_device):
    x = torch.randn(4, 50, 256, device=cuda_device, requires_grad=True)
    w = torch.ones(256, device=cuda_device, requires_grad=True)
    b = torch.zeros(256, device=cuda_device, requires_grad=True)
    before = layer_norm_fwd.launches, layer_norm_bwd.launches
    layer_norm(x, w, b, 1e-6, impl="pallas").square().sum().backward()
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    layer_norm(x, w, b, 1e-6, impl="xla").square().sum().backward()
    for a, t in zip(got, (x, w, b)):
        torch.testing.assert_close(a, t.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_layer_norm_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 100, device=cuda_device)
    w = torch.ones(100, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm_fwd(x, w, w, 1e-6)
    x = torch.zeros(4, 128, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        layer_norm_fwd(x, w[:1].expand(128), w[:1].expand(128), 1e-6)


def _q8_inputs(B, Lk, H, D, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H * D, generator=gen).to(device, dtype)
    k_i8, k_scale = quantize_kv_rows(torch.randn(B, Lk, H * D, generator=gen), H)
    v_i8, v_scale = quantize_kv_rows(torch.randn(B, Lk, H * D, generator=gen), H)
    mask = torch.rand(B, Lk, generator=gen) > 0.3
    mask[1] = False  # a dead row
    mask[2, Lk // 2:] = False  # a short prefix
    return [t.to(device) for t in (q, k_i8, v_i8, k_scale, v_scale, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_q8_decode_kernel_matches_plain(cuda_device, dtype, D):
    """The integer sums are exact; the two versions differ only where an
    ulp of exp moves p * v_scale across a rounding boundary of its int8
    grid, which moves one term by one step (at most max(p * v_scale))."""
    H = 768 // D
    args = _q8_inputs(4, 384, H, D, dtype, cuda_device, D)
    before = decode_attention_q8.launches
    o = decode_attention_q8(*args, num_heads=H)
    torch.cuda.synchronize()
    assert decode_attention_q8.launches == before + 1
    ref = decode_attention_q8_plain(*args, num_heads=H)
    torch.testing.assert_close(o.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert (o[1] == 0).all()


@pytest.mark.cuda
def test_q8_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k_i8, v_i8, ks, vs, mask = _q8_inputs(4, 128, 2, 64, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="int8"):
        decode_attention_q8(q, k_i8.float(), v_i8, ks, vs, mask, num_heads=2)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_q8(q, k_i8, v_i8, ks, vs, mask, num_heads=8)
    with pytest.raises(ValueError, match="mask shape"):
        decode_attention_q8(q, k_i8, v_i8, ks, vs, mask[:, :64], num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V,D", [(8, 57525, 1024), (16, 50265, 768), (3, 517, 64)])
def test_int8_head_is_exact_on_card(cuda_device, B, V, D):
    """The int8 tied head's product (``torch._int_mm`` on the card) equals
    the same integer product taken on the CPU."""
    gen = torch.Generator().manual_seed(V)
    table = torch.randn(V, D, generator=gen) * 0.05
    hidden = torch.randn(B, 1, D, generator=gen)
    got = q8_logits(hidden.to(cuda_device), *quantize_head(table.to(cuda_device)))
    want = q8_logits(hidden, *quantize_head(table))
    assert got.shape == (B, 1, V)
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["k64", "k128", "k64x2"])
@pytest.mark.parametrize("m,n,dots,repeats", [
    (128, 128, 3, 1), (128, 128, 3, 3),
    (256, 384, 8, 2),  # 128-column tiles
    (512, 256, 64, 256),  # the tool's size: 1024 (tile, repeat) pairs over the SMs
])
def test_mxu_probe_kernel_matches_plain(cuda_device, variant, m, n, dots, repeats):
    """fp32 sums of positive products in another order: 1e-4 relative; every
    repeat's slab is the same sum in the same order, bit for bit."""
    a, b = operands(variant, cuda_device, m=m, n=n, seed=dots)
    before = mxu_dots.launches
    out = mxu_dots(a, b, variant, dots=dots, repeats=repeats)
    torch.cuda.synchronize()
    assert mxu_dots.launches == before + 1
    assert out.shape == (repeats, m, n) and out.dtype == torch.float32
    torch.testing.assert_close(out[0], mxu_dots_plain(a, b, variant, dots=dots), rtol=1e-4, atol=0)
    assert bool((out == out[0]).all())


@pytest.mark.cuda
def test_mxu_probe_kernel_rejects_what_it_does_not_take(cuda_device):
    a, b = operands("k128", cuda_device, m=128, n=128)
    with pytest.raises(ValueError, match="bfloat16"):
        mxu_dots(a.float(), b.float(), "k128", dots=1, repeats=1)
    with pytest.raises(ValueError, match="multiples of 128"):
        mxu_dots(a[:, :64].contiguous(), b, "k128", dots=1, repeats=1)
    with pytest.raises(ValueError, match="contiguous"):
        mxu_dots(a.transpose(1, 2), b, "k128", dots=1, repeats=1)
    with pytest.raises(ValueError, match="repeats"):
        mxu_dots(a, b, "k128", dots=1, repeats=65536)


def _band_inputs(B, Hp, Wp, C, heads, win, device, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, Hp, Wp, 3 * C, generator=gen).to(device, torch.bfloat16)
    bias = (torch.randn(heads, win * win, win * win, generator=gen) * 0.5).to(device)
    return qkv, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hp,Wp,C,heads,win,tbw", [
    (1, 20, 20, 128, 4, 10, 2),  # the probe's smoke map
    (2, 20, 20, 128, 4, 10, 2),
    (1, 40, 30, 64, 2, 10, 3),
    (2, 40, 30, 64, 2, 10, 3),
    (2, 20, 30, 64, 2, 10, 3),
    (4, 320, 240, 128, 4, 10, 6),  # the probe's stage 0
    (1, 80, 60, 512, 16, 10, 6),  # the probe's stage-2 map at B = 1
    (2, 20, 20, 64, 4, 10, 2),  # head dim 16 (32-byte swizzle)
    (2, 20, 20, 128, 2, 10, 2),  # head dim 64 (128-byte swizzle)
    (2, 14, 21, 96, 3, 7, 3),  # window 7: 49 rows, odd (padded bias tables)
    (1, 24, 24, 128, 2, 12, 2),  # window 12: 144 rows, one unit a block
])
def test_window_band_kernel_matches_plain(cuda_device, B, Hp, Wp, C, heads, win, tbw):
    """bf16 1e-2 + 1e-2·|ref|, as #14; a second launch gives the same bits
    (every window's rows come from one box and are summed in one order)."""
    qkv, bias = _band_inputs(B, Hp, Wp, C, heads, win, cuda_device, Wp + C)
    before = banded_attention.launches
    o = banded_attention(qkv, bias, win, tbw)
    torch.cuda.synchronize()
    assert banded_attention.launches == before + 1
    assert o.shape == (B, Hp, Wp, C) and o.dtype == torch.bfloat16
    ref = banded_attention_plain(qkv, bias, win, tbw)
    torch.testing.assert_close(o.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert torch.equal(o, banded_attention(qkv, bias, win, tbw))


@pytest.mark.cuda
def test_window_band_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv, bias = _band_inputs(1, 20, 20, 128, 4, 10, cuda_device, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        banded_attention(qkv.float(), bias, 10, 2)
    with pytest.raises(ValueError, match="head dim 128"):
        banded_attention(qkv, bias[:1], 10, 2)  # one head of 128
    with pytest.raises(ValueError, match="contiguous"):
        banded_attention(qkv.transpose(1, 2), bias, 10, 2)
    big, big_bias = _band_inputs(1, 26, 26, 64, 2, 13, cuda_device, 0)
    with pytest.raises(ValueError, match="169 tokens"):
        banded_attention(big, big_bias, 13, 2)
