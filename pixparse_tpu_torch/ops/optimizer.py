"""One multi-tensor AdamW update on the card (``csrc/fused_adamw.cu``).

:func:`fused_adamw` takes a step of optax's chain (clip by global norm ->
Adam -> + weight decay on masked leaves -> layer-decay scale -> -lr, as
:class:`~pixparse_tpu_torch.framework.optimization.Optimizer` writes it)
over every leaf at once, IN PLACE: the parameters, the moments and the
update count change where they lie, and only if the gradient norm and the
loss are finite (else nothing changes and ``nonfinite`` reads 1). The
decision, the norm and the learning rate stay on the device.

A :class:`FusedAdamWPlan` holds the leaves (parameters, moments, decay
flags, layer scales) and their device tables and the norm's
scratch; it is built once and serves every step while the leaves stay
where they are (:meth:`FusedAdamWPlan.serves`).

The kernels have no CPU mode: a plan refuses leaves off the card, and the
CPU (the tests' reference) takes the optimizer chain, which the card tests
hold the kernels to. ``fused_adamw.launches`` counts kernel launches: two a
step (the norm, then the update).
"""

from __future__ import annotations

import array
import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pixparse_tpu_torch.ops import _build

FUSED_ADAMW_CHUNK = 16384  # elements a block: csrc/fused_adamw.cu kChunk
FUSED_ADAMW_MAX_LEAVES = 2048  # gradient pointers a launch carries: kMaxLeaves
_SCALARS = 8  # csrc/fused_adamw.cu kScalars
_MOMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fused_adamw.cu struct Leaf and struct Chunk
_LEAF_DTYPE = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("scale", "<f4"),
                        ("decay", "<i4")])
_CHUNK_DTYPE = np.dtype([("off", "<i8"), ("leaf", "<i4"), ("len", "<i4")])


def _addresses(tensors: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in tensors)


def chunk_table(sizes: Sequence[int]) -> np.ndarray:
    """The blocks of both launches: ``(off, leaf, len)`` per chunk of at
    most ``FUSED_ADAMW_CHUNK`` elements, leaf by leaf in order (an empty
    leaf has none)."""
    c = FUSED_ADAMW_CHUNK
    rows = [(off, i, min(c, n - off)) for i, n in enumerate(sizes) for off in range(0, n, c)]
    return np.array(rows, dtype=_CHUNK_DTYPE)


class FusedAdamWPlan:
    """The leaves of one fused update, in order: ``params`` (fp32), their
    moments ``mu`` and ``nu`` (fp32 or bf16, one dtype), ``decay`` (add
    ``weight_decay * p``) and ``scales`` (the layer-decay multiplier); and
    the kernels' leaf and chunk tables, the per-chunk partial norms and the
    ticket counter, so launches that share a plan must not overlap (one
    train step at a time). CUDA tensors only."""

    def __init__(self, names: Sequence[str], params: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 decay: Sequence[bool], scales: Sequence[float]):
        self.names = tuple(names)
        self.params, self.mu, self.nu = list(params), list(mu), list(nu)
        self.decay, self.scales = list(decay), [float(s) for s in scales]
        n = len(self.params)
        if not n or not all(len(x) == n for x in (self.names, self.mu, self.nu, self.decay,
                                                  self.scales)):
            raise ValueError("FusedAdamWPlan: one name, parameter, moment pair, decay flag "
                             "and scale per leaf, at least one leaf")
        device = self.params[0].device
        if device.type != "cuda":
            raise ValueError(f"FusedAdamWPlan: the kernels run on CUDA tensors, got {device}")
        mdtype = self.mu[0].dtype
        if mdtype not in _MOMENT_CODES:
            raise ValueError(f"FusedAdamWPlan: moments are float32 or bfloat16, got {mdtype}")
        for name, p, m, v in zip(self.names, self.params, self.mu, self.nu):
            if p.dtype != torch.float32 or p.device != device or not p.is_contiguous():
                raise ValueError(f"FusedAdamWPlan: {name} is not a contiguous float32 tensor "
                                 f"on {device}")
            for t in (m, v):
                if (t.dtype != mdtype or t.device != device or t.shape != p.shape
                        or not t.is_contiguous()):
                    raise ValueError(f"FusedAdamWPlan: {name}'s moments are not contiguous "
                                     f"{mdtype} tensors of its shape on {device}")
        self.device = device
        self.moment_dtype = mdtype
        self.addresses = _addresses(self.params + self.mu + self.nu)
        if n > FUSED_ADAMW_MAX_LEAVES:
            raise ValueError(f"FusedAdamWPlan: {n} leaves, the kernel takes at most "
                             f"{FUSED_ADAMW_MAX_LEAVES}")
        leaves = np.zeros(n, dtype=_LEAF_DTYPE)
        leaves["p"] = _addresses(self.params)
        leaves["m"] = _addresses(self.mu)
        leaves["v"] = _addresses(self.nu)
        leaves["scale"] = self.scales
        leaves["decay"] = self.decay
        chunks = chunk_table([p.numel() for p in self.params])
        if not len(chunks):
            raise ValueError("FusedAdamWPlan: every leaf is empty")
        self.n_chunks = len(chunks)
        self.leaf_table = torch.from_numpy(leaves.view(np.uint8)).to(device)
        self.chunk_table = torch.from_numpy(chunks.view(np.uint8)).to(device)
        self.partials = torch.empty(self.n_chunks, dtype=torch.float32, device=device)
        self.ticket = torch.zeros((), dtype=torch.int32, device=device)

    def serves(self, names: Sequence[str], params: Sequence[torch.Tensor],
               mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]) -> bool:
        """Whether these leaves are the plan's: the same names in the same
        order, at the same addresses (a restored checkpoint fills the same
        tensors; a replaced tensor or storage needs a new plan)."""
        return (tuple(names) == self.names
                and _addresses([*params, *mu, *nu]) == self.addresses)


def fused_adamw(plan: FusedAdamWPlan, grads: List[torch.Tensor], count: torch.Tensor,
                lr: torch.Tensor, loss: torch.Tensor, *, betas: Tuple[float, float], eps: float,
                weight_decay: float, max_norm: Optional[float] = None,
                skip_nonfinite: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step over ``plan``'s leaves with ``grads`` (one per leaf,
    its shape, float32), in place: ``(grad_norm, nonfinite)`` as 0-dim
    device tensors (fp32, int32). ``count`` (int32) is advanced by one on a
    step taken; ``lr`` is the learning rate of this step (a 0-dim tensor);
    ``max_norm``: clip by global norm (None: no clip). ``launches`` counts
    kernel launches."""
    device = plan.device
    if len(grads) != len(plan.params):
        raise ValueError(f"fused_adamw: {len(grads)} gradients for {len(plan.params)} leaves")
    # autograd hands back strided gradients at times (a transposed use)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    ptrs = array.array("Q", _addresses(grads))
    if count.dtype != torch.int32 or count.device != device or loss.device != device:
        raise ValueError("fused_adamw: the update count (int32) and the loss must lie on the "
                         "parameters' device")
    lr = lr.to(device=device, dtype=torch.float32)
    loss = loss.to(dtype=torch.float32)
    scal = torch.empty(_SCALARS, dtype=torch.float32, device=device)
    nonfinite = torch.empty((), dtype=torch.int32, device=device)
    b1, b2 = betas
    lib = _build.library("fused_adamw")
    with torch.cuda.device(device):
        err = lib.pixparse_fused_adamw(
            _MOMENT_CODES[plan.moment_dtype], ctypes.c_void_p(ptrs.buffer_info()[0]), len(ptrs),
            _build.ptr(plan.leaf_table), _build.ptr(plan.chunk_table), plan.n_chunks,
            _build.ptr(plan.partials), _build.ptr(plan.ticket), _build.ptr(loss),
            _build.ptr(lr), _build.ptr(count), _build.ptr(scal), _build.ptr(nonfinite),
            b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay, int(max_norm is not None),
            0.0 if max_norm is None else max_norm, int(skip_nonfinite),
            _build.stream_ptr(device),
        )
    _build.check(err, "fused_adamw")
    fused_adamw.launches += 2
    return scal[0], nonfinite


fused_adamw.launches = 0
