"""The device mesh over ``torch.distributed`` (counterpart of
:mod:`pixparse_tpu.parallel.mesh`).

- One process per device. Under ``torchrun`` (or SLURM) every process
  joins one process group, NCCL on CUDA and gloo on the CPU, and the
  ranks form a ``DeviceMesh`` with the JAX package's axes
  ``('data', 'fsdp', 'model')`` and its shape arithmetic
  (:func:`mesh_shape`: ``data = 0`` absorbs the rest).
- Training shards parameters and optimizer state with FSDP2
  (:func:`shard_model`): ``fully_shard`` on every encoder and decoder block,
  then on the root, over the ``(data, fsdp)`` sub-mesh. That is HSDP:
  dim 0 of each parameter split over ``fsdp``, replicated over ``data``;
  gradients reduce-scattered over ``fsdp`` and all-reduced over ``data``,
  their mean over the ranks. With ``fsdp = 1`` it is plain data
  parallelism.
- The ``model`` axis (tensor parallelism) is not ported: ``model > 1``
  raises.
- Each rank's loader yields its own slice of the global batch
  (:mod:`pixparse_tpu_torch.data`), so :func:`shard_batch` only moves it to
  the rank's device.
- Without a distributed environment :class:`MeshEnv` is one process on one
  device with no mesh: nothing is wrapped and no collective runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from pixparse_tpu_torch.device import batch_to_device, resolve_device

_logger = logging.getLogger(__name__)

MESH_AXES = ("data", "fsdp", "model")
MODEL_AXIS_TODO = (
    "--task.mesh.model > 1 (tensor parallelism) is not ported: ROADMAP.md Queue 1 "
    "item 7, the model axis"
)
# how long a collective may wait for the other ranks before it raises
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def is_distributed_env(environ: Optional[Mapping[str, str]] = None) -> bool:
    """True under ``torchrun`` (``WORLD_SIZE`` set, a world of one
    included) or a SLURM job of more than one task."""
    env = os.environ if environ is None else environ
    return "WORLD_SIZE" in env or int(env.get("SLURM_NTASKS", 1)) > 1


def mesh_shape(n: int, data: int = 0, fsdp: int = 1, model: int = 1) -> Tuple[int, int, int]:
    """``(data, fsdp, model)`` for ``n`` devices, as the JAX package's
    ``create_mesh`` sizes it: ``data = 0`` absorbs all remaining devices; a
    ``ValueError`` when the sizes do not divide or do not multiply to ``n``."""
    fsdp = max(1, fsdp)
    model = max(1, model)
    if data in (0, None):
        if n % (fsdp * model):
            raise ValueError(f"{n} devices not divisible by fsdp*model={fsdp * model}")
        data = n // (fsdp * model)
    if data * fsdp * model != n:
        raise ValueError(f"mesh {data}x{fsdp}x{model} != {n} devices")
    return data, fsdp, model


def create_mesh(data: int = 0, fsdp: int = 1, model: int = 1, device_type: str = "cuda"):
    """The global ``DeviceMesh`` over every rank of the process group (one
    device each), axes :data:`MESH_AXES`."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(dist.get_world_size(), data, fsdp, model)
    if shape[2] > 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def shard_batch(mesh, batch, stacked: bool = False, device=None):
    """This rank's slice of the global batch (a nested dict of numpy arrays
    or tensors) on its device. The loaders already split the data by rank,
    as the JAX package's per-host loaders do, so the slice is the batch the
    rank holds; ``stacked`` batches keep their accumulation axis first."""
    if device is None:
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return batch_to_device(batch, device)


def data_parallel_size(mesh) -> int:
    """Ranks that share the gradient mean: ``data * fsdp``."""
    return mesh["data"].size() * mesh["fsdp"].size()


def sum_over_ranks(mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ``(data, fsdp)`` ranks (a new tensor)."""
    t = t.detach().clone()
    for axis in ("data", "fsdp"):
        if mesh[axis].size() > 1:
            dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def mean_over_ranks(mesh, t: torch.Tensor) -> torch.Tensor:
    """Mean of ``t`` over the ``(data, fsdp)`` ranks (a new tensor), the
    mean FSDP2 takes of the gradients."""
    return sum_over_ranks(mesh, t) / data_parallel_size(mesh)


def _block_types():
    from pixparse_tpu_torch.models.bart import BartDecoderLayer
    from pixparse_tpu_torch.models.swin import SwinBlock
    from pixparse_tpu_torch.models.vit import Block

    return (Block, SwinBlock, BartDecoderLayer)


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """FSDP2 over the ``(data, fsdp)`` sub-mesh: ``fully_shard`` on each
    encoder and decoder block, then on the root, whose parameters (the
    embeddings, the tied head among them) stay whole from its forward to
    its backward, so a loss that reads the tied table after the model's
    forward reads a whole, plain tensor. The methods named in the model's
    ``fsdp_forward_methods`` run the root's forward hooks as ``forward``
    does. Returns ``model``, its parameters now ``DTensor`` shards."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    dp = mesh["data", "fsdp"]
    blocks = _block_types()
    for module in list(model.modules()):
        if module is not model and isinstance(module, blocks):
            fully_shard(module, mesh=dp)
    fully_shard(model, mesh=dp, reshard_after_forward=False)
    for name in getattr(model, "fsdp_forward_methods", ()):
        register_fsdp_forward_method(model, name)
    return model


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t):
    """The rank's local tensor of a ``DTensor`` (sharing its storage), any
    other value as it is."""
    return t.to_local() if is_sharded(t) else t


def local_shard(template, whole: torch.Tensor) -> torch.Tensor:
    """The rows of the whole tensor ``whole`` that the ``DTensor``
    ``template`` holds on this rank (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = template.device_mesh
    replicated = DTensor.from_local(
        whole.to(template.device), mesh, [Replicate()] * mesh.ndim, run_check=False)
    return replicated.redistribute(mesh, template.placements).to_local()


class ShardedParams:
    """What the optimizer needs to compute whole-parameter quantities from
    the local shards of FSDP2 parameters: ``sum`` adds partial sums over the
    ``fsdp`` ranks (shards of one replica), ``whole`` gathers a tensor laid
    out as a parameter, ``shard`` takes this rank's rows back out."""

    def __init__(self, params: Dict[str, Any], mesh):
        self.params = params
        self.group = mesh.get_group("fsdp") if mesh["fsdp"].size() > 1 else None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        p = self.params[name]
        return DTensor.from_local(
            shard, p.device_mesh, p.placements, run_check=False, shape=p.shape, stride=p.stride()
        ).full_tensor()

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        return local_shard(self.params[name], whole)


def _init_from_environment(device: torch.device) -> torch.device:
    """``init_process_group`` from torchrun's (or SLURM's) variables; the
    rank's device is ``cuda:{LOCAL_RANK}`` on CUDA."""
    env = os.environ
    if "WORLD_SIZE" not in env:  # SLURM: its task ids, the address from the job
        env["WORLD_SIZE"] = env["SLURM_NTASKS"]
        env.setdefault("RANK", env.get("SLURM_PROCID", "0"))
        env.setdefault("LOCAL_RANK", env.get("SLURM_LOCALID", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kwargs = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", timeout=PROCESS_GROUP_TIMEOUT, **kwargs)
    return device


@dataclasses.dataclass
class MeshEnv:
    """Process and mesh identity and host-object collectives (the JAX
    package's ``MeshEnv``): ``world_size`` / ``global_rank`` are processes,
    one device each; ``mesh`` is ``None`` in a process that runs alone."""

    device: torch.device
    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh
    process_index: int = 0
    process_count: int = 1

    @classmethod
    def initialize(cls, data: int = 0, fsdp: int = 1, model: int = 1,
                   device: str = "cuda") -> "MeshEnv":
        """Join the process group of a distributed environment and build the
        mesh; elsewhere one process on ``device``. A distributed environment
        whose initialisation fails raises: going on as rank 0 of a world of
        one would train every rank on the same data."""
        if max(1, model) > 1:
            raise NotImplementedError(MODEL_AXIS_TODO)
        dev = resolve_device(device)
        if not is_distributed_env():
            mesh_shape(1, data, fsdp, model)  # the mesh of one device must fit
            return cls(device=dev)
        try:
            dev = _init_from_environment(dev)
        except Exception as e:
            raise RuntimeError(
                "a distributed environment was detected (WORLD_SIZE or SLURM_NTASKS) but "
                "torch.distributed could not be initialised from it"
            ) from e
        mesh = create_mesh(data=data, fsdp=fsdp, model=model, device_type=dev.type)
        return cls(device=dev, mesh=mesh, process_index=dist.get_rank(),
                   process_count=dist.get_world_size())

    def close(self):
        """Leave the process group (the entry points call it on exit)."""
        if self.mesh is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.mesh = None

    # --- identity ---------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.process_count

    @property
    def global_rank(self) -> int:
        return self.process_index

    @property
    def num_devices(self) -> int:
        return self.mesh.size() if self.mesh is not None else 1

    def is_primary(self) -> bool:
        return self.process_index == 0

    # --- host-object collectives ------------------------------------------
    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        if self.process_count == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        if self.process_count == 1:
            return [obj]
        out: List[Any] = [None] * self.process_count
        dist.all_gather_object(out, obj)
        return out

    # --- data placement ---------------------------------------------------
    def shard_batch(self, batch, stacked: bool = False):
        return shard_batch(self.mesh, batch, stacked, device=self.device)

    def __str__(self):
        shape = (dict(zip(MESH_AXES, self.mesh.mesh.shape)) if self.mesh is not None
                 else "none")
        return (f"MeshEnv(process {self.process_index}/{self.process_count}, "
                f"device={self.device}, mesh={shape})")
