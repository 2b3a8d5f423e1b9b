"""The vocabulary-parallel fused CE's pieces, one process: the table cut
into 1, 2 or 4 row shards as the ``model`` axis cuts it (``ceil(V / S)``
rows, the last shard shorter), each shard's forward and backward with
targets shifted to it, then the merge (lse by max and sum, the target logit
summed, ``dh`` summed, ``dE`` concatenated), against the unsharded CE.

The targets fall in, before and after every shard, on its first and last
rows, and some rows are ignored. The CPU cases run the plain versions; the
``cuda`` cases run the kernels (a shard's target logit must be 0 for a
target outside it) and skip without a card.
"""

import numpy as np
import pytest
import torch

from pixparse_tpu_torch.ops import loss as tl
from pixparse_tpu_torch.parallel.tensor_parallel import TPLayout

# (device type, dtype) -> tolerances: the plain versions differ from the
# unsharded ones only in the order of the merge's and dh's sums; the kernels
# also in their products' order (chip_smoke's CE tolerances)
TOL = {("cpu", torch.float32): dict(lse=1e-5, dh=1e-5, de=1e-6),
       ("cpu", torch.bfloat16): dict(lse=1e-5, dh=2e-2, de=1e-6),
       ("cuda", torch.float32): dict(lse=1e-4, dh=1e-4, de=1e-4),
       ("cuda", torch.bfloat16): dict(lse=1e-3, dh=2e-2, de=2e-2)}


def _inputs(T, V, D, S, dtype, device, seed=0):
    """``h``, the table, safe targets (-1 where ignored) and the coefficients,
    with a target on the first and last row of every shard."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(T, D).astype(np.float32) * 0.5).to(device, dtype)
    e = torch.from_numpy(rng.randn(V, D).astype(np.float32) * 0.5).to(device, dtype)
    target = rng.randint(0, V, T)
    layout = TPLayout(0, V)
    edges = [v for s in range(S) for a, b in layout.spans(s, S) for v in (a, b - 1)]
    target[:len(edges)] = edges
    target[len(edges):len(edges) + 3] = -1  # ignored
    coef = torch.from_numpy(rng.rand(T).astype(np.float32)).to(device)
    target = torch.from_numpy(target).to(device)
    return h, e, target, torch.where(target >= 0, coef, 0.0)


def _sharded(h, e, target, coef, S):
    """Each shard's kernels (or plain versions), merged."""
    layout = TPLayout(0, e.shape[0])
    shards = [(layout.offset(s, S), layout.take(e, s, S)) for s in range(S)]
    fwd = [tl.fused_ce_fwd(h, es, tl.shard_targets(target, off)) for off, es in shards]
    lse, tgt = tl.merge_vocab_shards(torch.stack([f[0] for f in fwd]),
                                     torch.stack([f[1] for f in fwd]))
    bwd = [tl.fused_ce_bwd(h, es, tl.shard_targets(target, off), lse, coef) for off, es in shards]
    dh = torch.stack([b[0].float() for b in bwd]).sum(0).to(h.dtype)
    de = torch.cat([b[1] for b in bwd])
    return (lse, tgt, dh, de), fwd, shards


def _check(h, e, target, coef, S):
    (lse, tgt, dh, de), fwd, shards = _sharded(h, e, target, coef, S)
    want_lse, want_tgt = tl.fused_ce_fwd_plain(h, e, target)
    want_dh, want_de = tl.fused_ce_bwd_plain(h, e, target, want_lse, coef)
    tol = TOL[h.device.type, h.dtype]
    assert [es.shape[0] for _, es in shards] == [TPLayout(0, e.shape[0]).local_size(s, S)
                                                 for s in range(S)]
    for got, want, atol in ((lse, want_lse, tol["lse"]), (tgt, want_tgt, tol["lse"])):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=atol,
                                   rtol=tol["lse"])
    np.testing.assert_allclose(dh.float().cpu().numpy(), want_dh.float().cpu().numpy(),
                               atol=tol["dh"], rtol=tol["dh"])
    np.testing.assert_allclose(de.float().cpu().numpy(), want_de.float().cpu().numpy(),
                               atol=tol["de"], rtol=1e-2 if h.dtype == torch.bfloat16 else 1e-4)
    for (off, es), (_, shard_tgt) in zip(shards, fwd):
        outside = (target < off) | (target >= off + es.shape[0])
        assert torch.all(shard_tgt[outside] == 0)  # a target outside the shard: logit 0
    return fwd


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [307, 64])
def test_sharded_plain_ce_merges_to_the_unsharded_one(S, dtype, V):
    h, e, target, coef = _inputs(48, V, 16, S, dtype, "cpu")
    _check(h, e, target, coef, S)


def test_shards_follow_the_jax_padding():
    """``vs_raw = ceil(V / model)`` rows a shard, the last shorter:
    cruller_base's 50265 rows at model 2 and 4."""
    for S, rows in ((2, [25133, 25132]), (4, [12567, 12567, 12567, 12564])):
        layout = TPLayout(0, 50265)
        assert [layout.local_size(s, S) for s in range(S)] == rows
        assert [layout.offset(s, S) for s in range(S)] == [s * rows[0] for s in range(S)]


def test_shifted_targets_keep_ignored_rows_and_leave_the_shard():
    t = torch.tensor([-1, 0, 5, 9, 10, 19])
    assert tl.shard_targets(t, 10).tolist() == [-1, -10, -5, -1, 0, 9]


def test_a_dead_shard_adds_nothing_to_the_lse():
    lse = torch.tensor([[1.0, 2.0], [tl.DEAD_LSE, 0.5]])
    got, tgt = tl.merge_vocab_shards(lse, torch.tensor([[0.3, 0.0], [0.0, 0.1]]))
    assert got[0] == 1.0 and torch.allclose(got[1], torch.logaddexp(torch.tensor(2.0),
                                                                    torch.tensor(0.5)))
    assert tgt.tolist() == pytest.approx([0.3, 0.1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused CE kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 768)])
def test_sharded_kernels_merge_to_the_unsharded_ones(cuda_device, S, dtype, D):
    """The kernels on each shard (shifted targets) merged, against the
    unsharded plain CE; a shard's target logit is 0 outside it."""
    h, e, target, coef = _inputs(300, 3001, D, S, dtype, cuda_device)
    _check(h, e, target, coef, S)


def test_the_chunked_ce_takes_a_whole_table_only():
    h, e = torch.zeros(1, 2, 4), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="whole table"):
        tl.chunked_cross_entropy_from_hidden(h, e, torch.zeros(1, 2, dtype=torch.long),
                                             vocab_shard=(None, 0))


def test_shard_seeds_differ_by_model_rank():
    from pixparse_tpu_torch.parallel.tensor_parallel import shard_seed

    seeds = [shard_seed(12345, r) for r in range(4)]
    assert len(set(seeds + [12345])) == 5 and all(0 <= x < 2 ** 63 for x in seeds)
    assert seeds == [shard_seed(12345, r) for r in range(4)]  # a fixed mix
