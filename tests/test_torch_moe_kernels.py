"""The grouped expert kernels (``csrc/moe_expert_mm.cu``) against their
plain versions on the card, and the fused CE at the Moonlight head's width
(D = 2048). Card tests: they skip without one; on the card

    python -m pytest --noconftest -m cuda tests/test_torch_moe_kernels.py

The products run at cruller_moonlight's widths (D 2048, expert width 1408,
64 experts) on rows routed from sigmoid scores of random logits plus a
N(0, 0.1) correction bias, top 6 (loads near even; ``chip_smoke.py``'s
kernels phase runs them at the loads the full-size model's routers give)
and on hand-made counts with empty experts and row counts that are not a
multiple of the 128-row tile. Tolerance ``|kernel - plain| <= atol +
rtol |plain|`` with 1e-2 / 1e-2: both accumulate in fp32 and round once
to bf16, in another order.
"""

import pytest
import torch

from pixparse_tpu_torch.ops import moe
from pixparse_tpu_torch.ops.loss import (
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_ce_fwd,
    fused_ce_fwd_plain,
)

E, D, FE, K_TOP = 64, 2048, 1408, 6
TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped expert kernels have no CPU mode")
    return torch.device("cuda")


def _routed_offsets(tokens: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(tokens)
    scores = torch.sigmoid(torch.randn(tokens, E, device=device, generator=gen))
    bias = 0.1 * torch.randn(E, device=device, generator=gen)
    experts = torch.topk(scores + bias, K_TOP, dim=-1).indices
    return moe.sort_by_expert(experts, E).offsets


def _offsets(counts, device) -> torch.Tensor:
    c = torch.tensor([0] + list(counts), dtype=torch.int64)
    return c.cumsum(0).to(torch.int32).to(device)


def _hand_counts():
    counts = [0] * E
    for e in range(E):
        counts[e] = (e * 97) % 301  # 0 (an empty expert) .. 300, mostly ragged
    counts[5] = counts[6] = 0
    counts[7] = 128  # exactly one tile
    counts[8] = 1
    return counts


def _cases(device):
    return [("routed", _routed_offsets(4096, device)), ("hand", _offsets(_hand_counts(), device))]


def _operands(offsets, device, seed):
    R = int(offsets[-1])
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device=device, generator=gen).bfloat16()  # noqa: E731
    return R, rnd


@pytest.mark.cuda
def test_six_products_match_plain(cuda_device):
    for name, offsets in _cases(cuda_device):
        R, rnd = _operands(offsets, cuda_device, 0)
        x, h = rnd(R, D), rnd(R, FE)
        dy1, dy2 = rnd(R, 2 * FE), rnd(R, D)
        w1, w2 = rnd(E, 2 * FE, D) * 0.05, rnd(E, D, FE) * 0.05
        before = moe.moe_expert_mm.launches, moe.moe_expert_wgrad.launches
        mm, mm_plain = moe.moe_expert_mm, moe.moe_expert_mm_plain
        wgrad, wgrad_plain = moe.moe_expert_wgrad, moe.moe_expert_wgrad_plain
        products = {
            "gate_up": (mm(x, w1, offsets), mm_plain(x, w1, offsets)),
            "down": (mm(h, w2, offsets), mm_plain(h, w2, offsets)),
            "dx": (mm(dy1, w1, offsets, b_kn=True), mm_plain(dy1, w1, offsets, b_kn=True)),
            "dh": (mm(dy2, w2, offsets, b_kn=True), mm_plain(dy2, w2, offsets, b_kn=True)),
            "dw1": (wgrad(dy1, x, offsets), wgrad_plain(dy1, x, offsets)),
            "dw2": (wgrad(dy2, h, offsets), wgrad_plain(dy2, h, offsets)),
        }
        torch.cuda.synchronize()
        assert (moe.moe_expert_mm.launches, moe.moe_expert_wgrad.launches) == (
            before[0] + 4, before[1] + 2)
        for what, (got, want) in products.items():
            torch.testing.assert_close(got.float(), want.float(), **TOL, msg=f"{name} {what}")
        counts = (offsets[1:] - offsets[:-1]).tolist()
        for e in (e for e, n in enumerate(counts) if n == 0):
            assert all(bool((products[w][0][e] == 0).all()) for w in ("dw1", "dw2"))
        again = moe.moe_expert_mm(x, w1, offsets)
        assert torch.equal(again, products["gate_up"][0])  # one owner per element: same bits


@pytest.mark.cuda
def test_routed_experts_autograd_through_the_kernels(cuda_device, monkeypatch):
    """Forward and backward of the expert FFN through the kernels against
    the same autograd functions over the plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, device=cuda_device, generator=gen)  # noqa: E731
    T = 2048
    h = rnd(T, D).bfloat16()
    gate = rnd(E, D) * D ** -0.5
    bias = 0.1 * rnd(E)
    w1, w2 = (rnd(E, 2 * FE, D) * D ** -0.5).bfloat16(), (rnd(E, D, FE) * FE ** -0.5).bfloat16()
    dout = rnd(T, D).bfloat16()

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (h, gate, w1, w2)]
        out = moe.routed_experts(leaves[0], leaves[1], bias, leaves[2], leaves[3], K_TOP,
                                 2.446, True)
        out.backward(dout)
        return [out] + [t.grad for t in leaves]

    got = run()
    monkeypatch.setattr(moe, "moe_expert_mm", moe.moe_expert_mm_plain)
    monkeypatch.setattr(moe, "moe_expert_wgrad", moe.moe_expert_wgrad_plain)
    want = run()
    for name, a, b in zip(("out", "dh", "dgate", "dw1", "dw2"), got, want):
        scale = float(b.detach().float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2 * scale, rtol=1e-2, msg=name)


@pytest.mark.cuda
def test_grouped_kernels_refuse_what_they_do_not_take(cuda_device):
    offsets = _offsets([3, 5], cuda_device)
    zeros = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=cuda_device)  # noqa: E731
    x = zeros(8, 64)  # K = 64: fine
    with pytest.raises(ValueError):  # N = 100 is not a multiple of 128
        moe.moe_expert_mm(x, zeros(2, 100, 64), offsets)
    with pytest.raises(ValueError):  # fp32 operands
        moe.moe_expert_mm(x.float(), zeros(2, 128, 64).float(), offsets)
    with pytest.raises(ValueError):  # int64 offsets
        moe.moe_expert_wgrad(zeros(8, 128), zeros(8, 128), offsets.long())


@pytest.mark.cuda
@pytest.mark.parametrize("T,V", [(300, 1000), (1023, 163840)])
def test_fused_ce_at_d2048_matches_plain(cuda_device, T, V):
    """The fused CE at the Moonlight head's width, bf16, with ignored rows;
    the tolerances of tests/test_torch_kernels.py's fused-CE tests."""
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    h = torch.randn(T, D, device=cuda_device, generator=gen).bfloat16()
    e = (torch.randn(V, D, device=cuda_device, generator=gen) * D ** -0.5).bfloat16()
    target = torch.randint(0, V, (T,), device=cuda_device, generator=gen)
    target[::7] = -1
    lse, tgt = fused_ce_fwd(h, e, target)
    lse_ref, tgt_ref = fused_ce_fwd_plain(h, e, target)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(tgt, tgt_ref, atol=1e-3, rtol=1e-4)
    coef = torch.where(target >= 0, 1.0 / T, 0.0)
    dh, de = fused_ce_bwd(h, e, target, lse_ref, coef)
    dh_ref, de_ref = fused_ce_bwd_plain(h, e, target, lse_ref, coef)
    torch.testing.assert_close(dh.float(), dh_ref.float(), atol=2e-5, rtol=2e-2)
    torch.testing.assert_close(de.float(), de_ref.float(), atol=2e-5, rtol=2e-2)
    assert (dh[target < 0] == 0).all()
