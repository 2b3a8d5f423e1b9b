"""Checkpoint save/load of the full train state, one per interval
(counterpart of :mod:`pixparse_tpu.framework.checkpoint`).

Layout as in the JAX package: ``{output_dir}/checkpoint-{interval}/``, a
directory, so ``--train.resume`` finds the newest one. Inside,
``state.pt`` holds the train state (``torch.save``: step, parameters by
name, optimizer state, dropout seed) and ``metadata.json`` the small
metadata dict (interval and step counters), in place of the JAX package's
orbax tree. Saves are synchronous; :func:`wait_for_saves` is kept so callers
read the same as there.

A state sharded over a mesh (FSDP2 ``DTensor`` parameters and moments) is
saved by every rank with ``torch.distributed.checkpoint`` into the same
directory (its ``.metadata`` and one ``.distcp`` file per rank, beside
``metadata.json``, which rank 0 writes). A restore reshards onto the
template, as orbax does: a sharded save loads at another mesh or in one
process, and a one-process ``state.pt`` loads into a sharded template.

Under tensor parallelism (``state.tp``) the save holds whole tensors under
the reference names and shapes, laid out over the ``model`` axis: a split
parameter (and its moments) as a ``DTensor`` sharded over the model ranks
(its ``(data, fsdp)`` shards gathered first), a fused q/k/v one, whose
shard is three runs, gathered whole, the rest replicated. So a
tensor-parallel save loads in one process or at any other mesh, and any
save loads at ``model > 1`` (read whole on each rank, this rank's part
taken).
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional, Tuple

import torch

from pixparse_tpu_torch.framework.train_state import TrainState

_logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"checkpoint-(\d+)$")
STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def checkpoint_path(output_dir: str, interval: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{interval}")


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest ``checkpoint-{i}`` dir under ``output_dir`` (None if none)."""
    if not os.path.isdir(output_dir):
        return None
    best, best_i = None, -1
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        path = os.path.join(output_dir, name)
        if m and os.path.isdir(path) and int(m.group(1)) > best_i:
            best_i = int(m.group(1))
            best = path
    return best


def wait_for_saves():
    """Saves are synchronous: nothing is ever in flight."""


def _is_sharded_state(state: TrainState) -> bool:
    from pixparse_tpu_torch.parallel.mesh import is_sharded

    return any(is_sharded(p) for p in state.params.values())


def _dcp_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "seed": state.seed}


def _by_param(state: TrainState, fn) -> dict:
    """``_dcp_tree`` with ``fn(name, tensor)`` on every parameter and every
    per-parameter optimizer tensor (the moments), in a fixed order."""
    def moments(v):
        return {n: fn(n, t) for n, t in v.items()} if isinstance(v, dict) else v

    return {"params": {n: fn(n, t) for n, t in state.params.items()},
            "opt_state": {k: moments(v) for k, v in state.opt_state.items()},
            "step": state.step, "seed": state.seed}


def _tp_save_tree(state: TrainState) -> dict:
    """The tensor-parallel save's tree (see the module docstring): a
    collective over the mesh."""
    from torch.distributed.tensor import DTensor, Shard

    from pixparse_tpu_torch.parallel.mesh import is_sharded
    from pixparse_tpu_torch.parallel.tensor_parallel import gather_whole

    tp = state.tp

    def laid_out(name, t):
        t = (t.full_tensor() if is_sharded(t) else t).detach()
        layout = state.tp_layouts.get(name)
        if layout is None:
            return t
        if layout.groups > 1:
            return gather_whole(t, layout, tp)
        shape = list(t.shape)
        shape[layout.dim] = layout.n
        return DTensor.from_local(t.contiguous(), tp.mesh, [Shard(layout.dim)], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    return _by_param(state, laid_out)


def _whole_template(state: TrainState) -> dict:
    """CPU tensors of the whole shapes of a tensor-parallel state's
    tensors, for a load that reads every tensor whole."""
    def whole(name, t):
        shape = list(t.shape)
        layout = state.tp_layouts.get(name)
        if layout is not None:
            shape[layout.dim] = layout.n
        return torch.empty(shape, dtype=t.dtype)

    return _by_param(state, whole)


def save_checkpoint(path: str, state: TrainState, metadata: Optional[dict] = None):
    """Write the train state (and a small metadata dict) to the directory
    ``path``. The state file is written under a temporary name and renamed,
    so a directory never holds half a state. A sharded state: every rank
    must call this (a collective save)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if _is_sharded_state(state):
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        dcp.save(_tp_save_tree(state) if state.tp is not None else _dcp_tree(state),
                 checkpoint_id=path)
        if dist.get_rank() == 0:
            with open(os.path.join(path, METADATA_FILE), "w") as fh:
                json.dump(dict(metadata or {}), fh)
        dist.barrier()
        _logger.info("saved sharded checkpoint %s", path)
        return
    payload = {
        "step": state.step,
        "seed": state.seed,
        "params": {k: v.detach() for k, v in state.params.items()},
        "opt_state": state.opt_state,
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, METADATA_FILE), "w") as fh:
        json.dump(dict(metadata or {}), fh)
    _logger.info("saved checkpoint %s", path)


def _load_into(template, saved, what: str, state: Optional[TrainState] = None, name=None):
    """Copy ``saved`` into the tensors of ``template`` (same nesting), so
    the restored state lives where the template's does. With a
    tensor-parallel ``state`` each split tensor of ``saved`` is whole and
    this rank's part of it is taken."""
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(
                f"checkpoint {what} keys differ: missing {sorted(set(template) - set(saved))}, "
                f"unexpected {sorted(set(saved) - set(template))}"
            )
        return {k: _load_into(v, saved[k], f"{what}.{k}", state, k) for k, v in template.items()}
    if state is not None and state.tp is not None and name in state.tp_layouts:
        saved = state.tp_layouts[name].take(saved, state.tp.rank, state.tp.size)
    if template.shape != saved.shape:
        raise ValueError(f"checkpoint {what}: shape {tuple(saved.shape)} != {tuple(template.shape)}")
    from pixparse_tpu_torch.parallel.mesh import is_sharded, local_shard

    with torch.no_grad():
        if is_sharded(template):  # this rank's rows of the whole saved tensor
            template.to_local().copy_(local_shard(template, saved))
        else:
            template.copy_(saved)
    return template


def restore_train_state(path: str, state_template: TrainState) -> Tuple[TrainState, dict]:
    """Restore onto an existing state: the template supplies device and dtype
    for every tensor, and its parameter tensors (the model's own) are filled
    in place. Returns ``(state, metadata)``. Either format loads into either
    template: a ``state.pt`` or a sharded save, into a state of one process
    or one sharded over any mesh (every rank of a mesh calls this)."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, STATE_FILE)):
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    else:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        if not os.path.exists(os.path.join(path, ".metadata")):
            raise FileNotFoundError(f"{path} holds neither {STATE_FILE} nor a sharded save")
        if state_template.tp is None:
            saved = _dcp_tree(state_template)
            dcp.load(saved, checkpoint_id=path, no_dist=not dist.is_initialized())
        else:
            saved = _whole_template(state_template)
            dcp.load(saved, checkpoint_id=path)
    if saved["params"] is state_template.params:  # loaded in place
        params, opt_state = saved["params"], saved["opt_state"]
    else:
        params = _load_into(state_template.params, saved["params"], "params", state_template)
        opt_state = _load_into(state_template.opt_state, saved["opt_state"], "opt_state",
                               state_template)
    metadata = {}
    meta_path = os.path.join(path, METADATA_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            metadata = json.load(fh)
    else:
        _logger.warning(
            "no metadata in %s: interval and step counters restart from 0", path
        )
    state = TrainState(
        step=int(saved["step"]), params=params, opt_state=opt_state, seed=int(saved["seed"]),
        tp=state_template.tp, tp_layouts=state_template.tp_layouts,
    )
    return state, metadata
