"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and the port only (no JAX), so it runs on a CUDA
machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a card the ``cuda``-marked tests skip: a CUDA kernel has no CPU
mode. chip_smoke.py holds the same kernels against the same plain versions
at the serving path's shapes. The unmarked tests check the host-side pieces
around the kernels (the build cache key, the split heuristic), which run
anywhere.
"""

import pytest
import torch

from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    num_splits,
)
from pixparse_tpu_torch.ops.flash_attention import (
    DEAD_LSE,
    flash_attention_fwd,
    flash_attention_plain,
)

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


@pytest.mark.parametrize(
    "batch_heads,Lk,want",
    [(192, 1024, 3), (192, 64, 1), (12, 1024, 16), (4000, 1024, 1), (192, 1, 1)],
)
def test_decode_split_count(batch_heads, Lk, want):
    """About 4 blocks per SM on a 132-SM card, never under 64 keys a split."""
    assert num_splits(batch_heads, Lk, 132) == want


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


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 1, 96, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 96, device=cuda_device, dtype=torch.bfloat16)
    mask = torch.ones(2, 16, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, k, k, mask, num_heads=2)
    with pytest.raises(ValueError, match="mask shape"):
        decode_attention(q, k, k, mask[:, :8], num_heads=3)
