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
- The ``model`` axis is tensor parallelism
  (:mod:`pixparse_tpu_torch.parallel.tensor_parallel`): :func:`shard_model`
  first cuts heads, MLP and vocabulary over it by the plan that
  :data:`DEFAULT_LOGICAL_RULES` gives (the one source of it, as in the JAX
  package), then applies FSDP2 over ``(data, fsdp)``: PyTorch's 2-D order.
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

# logical axis name -> mesh axis (or tuple of mesh axes), as the JAX
# package's rules; FSDP2 shards dim 0 of every parameter over fsdp whatever
# these say, so the port reads only their "model" entries
DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp")),  # batch dim of activations
    ("embed", "fsdp"),            # model width
    ("mlp", "model"),             # FFN hidden
    ("heads", "model"),           # attention heads
    ("kv", None),                 # per-head dim
    ("vocab", ("model", "fsdp")),  # token table rows
    ("vocab_embed", None),
    ("length", None),
    ("image_length", None),
    ("patch", None),
    ("norm", None),
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
    device each), axes :data:`MESH_AXES`; ranks are laid out row-major, so
    a ``model`` group is ``model`` consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(dist.get_world_size(), data, fsdp, model)
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def resolve_logical(logical_spec, rules=DEFAULT_LOGICAL_RULES) -> Tuple[Any, ...]:
    """A spec of logical axis names -> one entry per dim: a mesh axis, a
    tuple of them, or None."""
    table = dict(rules)
    out = []
    for axis in logical_spec:
        if axis is None:
            out.append(None)
        elif isinstance(axis, (tuple, list)):
            resolved: List[str] = []
            for a in axis:
                r = table.get(a)
                if r is not None:
                    resolved.extend(r if isinstance(r, (tuple, list)) else [r])
            out.append(tuple(resolved) if resolved else None)
        else:
            out.append(table.get(axis))
    return tuple(out)


def logical_sharding(logical_spec, mesh=None, rules=DEFAULT_LOGICAL_RULES) -> Tuple[Any, ...]:
    """The JAX package's ``logical_sharding``: a spec of logical axis names
    -> the mesh axes of each dim (a ``PartitionSpec``'s entries); rank-1
    specs are replicated, as there. ``mesh`` is kept for its signature.
    The tensor-parallel plan reads the ``model`` entries of these
    (:func:`~pixparse_tpu_torch.parallel.tensor_parallel.param_layout`)."""
    if len(logical_spec) == 1:
        return (None,)
    return resolve_logical(logical_spec, rules)


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


def data_parallel_rank(mesh) -> int:
    """This rank's index among the ``(data, fsdp)`` ranks: the ranks of one
    ``model`` group share it."""
    return mesh["data"].get_local_rank() * mesh["fsdp"].size() + mesh["fsdp"].get_local_rank()


def model_parallel_size(mesh) -> int:
    """The ``model`` axis' size (1 without a mesh)."""
    return 1 if mesh is None else mesh["model"].size()


def tp_group(mesh):
    """This rank's :class:`~pixparse_tpu_torch.parallel.tensor_parallel.TPGroup`,
    or None when the ``model`` axis is 1."""
    from pixparse_tpu_torch.parallel.tensor_parallel import TPGroup

    if model_parallel_size(mesh) == 1:
        return None
    sub = mesh["model"]
    return TPGroup(group=mesh.get_group("model"), rank=sub.get_local_rank(), size=sub.size(),
                   mesh=sub)


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
    """With ``model > 1`` first the tensor-parallel cut
    (:func:`~pixparse_tpu_torch.parallel.tensor_parallel.parallelize`), then
    FSDP2 over the ``(data, fsdp)`` sub-mesh: ``fully_shard`` on each
    encoder and decoder block, then on the root, whose parameters (the
    embeddings, the tied head among them) stay whole from its forward to
    its backward, so a loss that reads the tied table after the model's
    forward reads a whole, plain tensor (this rank's vocabulary rows under
    tensor parallelism). The methods named in the model's
    ``fsdp_forward_methods`` run the root's forward hooks as ``forward``
    does. Returns ``model``, its parameters now ``DTensor`` shards."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    tp = tp_group(mesh)
    if tp is not None:
        from pixparse_tpu_torch.parallel.tensor_parallel import parallelize

        parallelize(model, tp)
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
    the local shards of FSDP2 (and tensor-parallel) parameters: ``sum``
    adds per-parameter partial sums over the ``fsdp`` ranks (shards of one
    replica) and, for the parameters split over ``model``, over the model
    ranks (a replicated parameter counts once); ``whole`` gathers a tensor
    laid out as a parameter, ``shard`` takes this rank's part back out."""

    def __init__(self, params: Dict[str, Any], mesh, tp=None, layouts=None):
        self.params = params
        self.group = mesh.get_group("fsdp") if mesh["fsdp"].size() > 1 else None
        self.tp, self.layouts = tp, dict(layouts or {})
        self._split = None
        if tp is not None:
            self._split = torch.tensor([n in self.layouts for n in params])

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t``: per-parameter partial sums, in the parameters' order (one
        or more rounds of them, concatenated)."""
        if self.group is not None:
            t = t.clone()
            dist.all_reduce(t, group=self.group)
        if self.tp is not None:
            from pixparse_tpu_torch.parallel.tensor_parallel import all_reduce_model

            split = self._split.to(t.device).repeat(t.numel() // self._split.numel())
            t = torch.where(split, all_reduce_model(t, self.tp), t)
        return t

    def whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        p = self.params[name]
        t = DTensor.from_local(
            shard, p.device_mesh, p.placements, run_check=False, shape=p.shape, stride=p.stride()
        ).full_tensor()
        if name in self.layouts:
            from pixparse_tpu_torch.parallel.tensor_parallel import gather_whole

            t = gather_whole(t, self.layouts[name], self.tp)
        return t

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        if name in self.layouts:
            whole = self.layouts[name].take(whole, self.tp.rank, self.tp.size)
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

    @property
    def data_size(self) -> int:
        """Processes that read different data: the ``(data, fsdp)`` ranks
        (the ranks of one ``model`` group read the same batches)."""
        return self.process_count if self.mesh is None else data_parallel_size(self.mesh)

    @property
    def data_rank(self) -> int:
        """This process's index among the :attr:`data_size` readers."""
        return self.process_index if self.mesh is None else data_parallel_rank(self.mesh)

    @property
    def model_rank(self) -> int:
        """This process's index on the ``model`` axis (0 without a mesh):
        the ranks of one model group share :attr:`data_rank` and differ
        here."""
        return 0 if self.mesh is None else self.mesh["model"].get_local_rank()

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
