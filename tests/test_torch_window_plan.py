"""The window kernels' work plan (``ops/window_attention.py::window_plan``),
on the CPU: pure Python, the same arithmetic as the kernels'
``window_ring.cuh::block_run``.

donut_base's four stages at B=2 (training) and B=8 (serving), 2560x1920
pages with window 10, shifted (the mask period is the windows per image)
and not (period 1, as the wrapper passes it), and windows 7 and 4; on 132
SMs (an H100) and on 7; one and two blocks per SM.
"""

import pytest
import torch

from pixparse_tpu_torch.ops.window_attention import (
    bwd_partials_shape,
    table_layout,
    window_plan,
    _tables,
)


def plan_runs(plan, H):
    """(head, first item, end item) of every block, in block order: the
    kernels' window_ring.cuh::block_run."""
    return [(x % H, (x // H) * plan.items // plan.runs, (x // H + 1) * plan.items // plan.runs)
            for x in range(plan.grid)]


def plan_windows(plan, H, period):
    """The (window, head) pairs of every block, in the order it takes them:
    item i of a head is window (i % n_images) * period + i // n_images."""
    n_images = plan.items // period
    return [[((i % n_images) * period + i // n_images, h) for i in range(b, e)]
            for h, b, e in plan_runs(plan, H)]


def _cases():
    out = []
    for B in (2, 8):
        for stage, (C, H) in enumerate(((128, 4), (256, 8), (512, 16), (1024, 32))):
            nW = (64 >> stage) * (48 >> stage)  # windows of 10 x 10 per image
            for shifted in (True, False):
                tag = f"stage{stage}_b{B}_{'shifted' if shifted else 'unshifted'}"
                out.append((tag, B * nW, nW if shifted else 1, H, 100, C // H))
    out += [("window7_b2", 2 * 64, 64, 4, 49, 32), ("window4_b8", 8 * 16, 16, 2, 16, 16)]
    return out


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("n_sms", [132, 7])
@pytest.mark.parametrize("tag,nB,period,H,N,D", _cases())
def test_plan_takes_every_item_once_in_balanced_runs(tag, nB, period, H, N, D, n_sms,
                                                     blocks_per_sm):
    plan = window_plan(nB, period, H, N, D, n_sms, blocks_per_sm)
    assert plan.grid == H * plan.runs and plan.items == nB
    slots = n_sms * blocks_per_sm
    # one wave whenever the heads fit, and at most one item a run
    assert plan.grid <= max(slots, H) and plan.runs <= nB
    if H <= slots and plan.runs < nB:
        assert plan.grid > slots - H
    runs = plan_runs(plan, H)
    windows = plan_windows(plan, H, period)
    seen = [pair for block in windows for pair in block]
    assert len(seen) == nB * H and set(seen) == {(w, h) for w in range(nB) for h in range(H)}
    sizes = [e - b for _, b, e in runs]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    # the heads' blocks of one run index take the same windows in the same order
    for r in range(plan.runs):
        firsts = {tuple(w for w, _ in windows[r * H + h]) for h in range(H)}
        assert len(firsts) == 1 and all(windows[r * H + h][0][1] == h for h in range(H))
    # a run walks window positions in order, all images of one before the next
    n_images = nB // period
    for block in windows:
        positions = [w % period for w, _ in block]
        assert positions == sorted(positions)
        if len(block) >= n_images:
            assert len(set(positions[:n_images])) <= 2
    # one dbias partial per block: (h, r) covers the scratch exactly once
    shape = bwd_partials_shape(plan, H, N)
    assert shape == (H, plan.runs, N, N)
    assert sorted((x % H, x // H) for x in range(plan.grid)) == [
        (h, r) for h in range(shape[0]) for r in range(shape[1])]


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="period"):
        window_plan(10, 3, 2, 49, 32, 132, 1)
    with pytest.raises(ValueError, match="head dim"):
        window_plan(8, 1, 2, 49, 48, 132, 1)
    with pytest.raises(ValueError, match="tokens"):
        window_plan(8, 1, 2, 169, 32, 132, 1)
    with pytest.raises(ValueError, match="SMs"):
        window_plan(8, 1, 2, 49, 32, 132, 0)


def test_more_heads_than_blocks_gives_one_run_each():
    plan = window_plan(96, 48, 32, 100, 32, 7, 1)
    assert plan.runs == 1 and plan.grid == 32


@pytest.mark.parametrize("N", [100, 49, 16, 1, 144])
def test_bias_and_mask_tables(N):
    """The kernels read bias and mask as N rows of ldb (even) floats, one
    table every nn (a multiple of 4) floats: a view for even N, a padded copy
    for odd N."""
    ldb, nn = table_layout(N)
    assert ldb % 2 == 0 and ldb - N in (0, 1) and nn % 4 == 0 and nn >= N * ldb
    t = torch.randn(3, N, N)
    got = _tables(t, N)
    assert got.shape == (3, nn) and got.dtype == torch.float32
    rows = got[:, : N * ldb].view(3, N, ldb)
    assert torch.equal(rows[:, :, :N], t)
    if ldb == N and nn == N * N:
        assert got.data_ptr() == t.data_ptr()
    else:
        assert not rows[:, :, N:].any() and not got[:, N * ldb:].any()
