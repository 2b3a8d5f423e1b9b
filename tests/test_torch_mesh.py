"""The port's mesh layer against the JAX package's, in one process on the
CPU: the mesh shape arithmetic against ``create_mesh`` over the 8 virtual
CPU devices (``tests/conftest.py``), the eval metric merge, the
``--task.mesh.*`` flags, the dataset loader's rank stripes, and what a
process without a distributed
environment gets (no process group, no mesh, nothing wrapped). The
multi-process paths are ``tests/test_torch_distributed.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pixparse_tpu.app.eval import _merge_metric_trees as jax_merge
from pixparse_tpu.framework.cli import ConfigArgumentParser as JaxParser
from pixparse_tpu.parallel.mesh import create_mesh as jax_create_mesh
from pixparse_tpu.task.task_factory import TASK_CLASS_REGISTRY as JAX_TASKS
from pixparse_tpu_torch.app.eval import _merge_metric_trees
from pixparse_tpu_torch.framework.cli import ConfigArgumentParser
from pixparse_tpu_torch.framework.config import MeshCfg
from pixparse_tpu_torch.framework.train_state import dropout_seed
from pixparse_tpu_torch.parallel import mesh as mesh_mod
from pixparse_tpu_torch.parallel.mesh import MeshEnv, is_distributed_env, mesh_shape
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY

SHAPES = [  # devices, data, fsdp, model
    (8, 0, 1, 1), (8, 0, 2, 1), (8, 0, 4, 1), (8, 2, 2, 2), (8, 0, 2, 2), (8, 1, 8, 1),
    (4, 2, 2, 1), (4, 0, 1, 4), (2, 2, 1, 1), (1, 0, 1, 1), (8, None, 2, 1), (8, 0, 0, 1),
]
BAD_SHAPES = [(8, 0, 3, 1), (8, 3, 1, 1), (4, 1, 2, 1), (8, 2, 2, 1), (2, 0, 1, 4), (1, 0, 2, 1)]


@pytest.mark.parametrize("n,data,fsdp,model", SHAPES)
def test_mesh_shape_equals_jax_create_mesh(n, data, fsdp, model):
    want = jax_create_mesh(data, fsdp, model, devices=jax.devices()[:n]).devices.shape
    assert mesh_shape(n, data, fsdp, model) == tuple(want)


@pytest.mark.parametrize("n,data,fsdp,model", BAD_SHAPES)
def test_mesh_shape_raises_where_jax_raises(n, data, fsdp, model):
    with pytest.raises(ValueError) as want:
        jax_create_mesh(data, fsdp, model, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        mesh_shape(n, data, fsdp, model)
    assert str(got.value) == str(want.value)


TREES = {
    "nested": [
        {"eval": {"average": {"cer": 0.25, "wer": 0.5, "num_samples": 3}}},
        {"eval": {"average": {"cer": 0.5, "wer": 0.25, "num_samples": 5}}},
    ],
    "count_named": [
        {"correct": 3, "total": 8, "num_pages": 2, "sample_count": 7, "accuracy": 0.375},
        {"correct": 5, "total": 6, "num_pages": 1, "sample_count": 2, "accuracy": 5 / 6},
        {"correct": 0, "total": 1, "num_pages": 4, "sample_count": 1, "accuracy": 0.0},
    ],
    "ratio": [{"cer": 0.1 * (r + 1), "f1": 0.9 - 0.2 * r} for r in range(4)],
    "ragged": [  # a key only some ranks report, a non-numeric leaf
        {"a": {"cer": 0.2, "name": "x"}, "b": 1.0},
        {"a": {"cer": 0.4, "name": "y"}},
    ],
    "one_rank": [{"cer": 0.3, "num_samples": 9}],
}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_merge_metric_trees_equals_jax(kind):
    trees = TREES[kind]
    assert _merge_metric_trees(trees) == jax_merge(trees)


def _parse(parser_cls, cfg_cls, argv):
    parser = parser_cls(description="t")
    parser.add_arguments(cfg_cls, dest="task")
    return parser.parse_args(argv).task


@pytest.mark.parametrize("task_name", ["cruller_pretrain", "cruller_eval_ocr"])
@pytest.mark.parametrize("argv", [
    [],
    ["--task.mesh.data", "2", "--task.mesh.fsdp", "4"],
    ["--task.mesh.fsdp", "2", "--task.mesh.model", "1", "--task.mesh.data", "0"],
])
def test_mesh_flags_parse_as_jax(task_name, argv):
    got = _parse(ConfigArgumentParser, TASK_CLASS_REGISTRY[task_name][1], argv).mesh
    want = _parse(JaxParser, JAX_TASKS[task_name][1], argv).mesh
    assert isinstance(got, MeshCfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("environ,want", [
    ({}, False),
    ({"WORLD_SIZE": "1"}, True),
    ({"WORLD_SIZE": "4", "RANK": "2"}, True),
    ({"SLURM_NTASKS": "1"}, False),
    ({"SLURM_NTASKS": "2"}, True),
    ({"JAX_COORDINATOR_ADDRESS": "h:1"}, False),
])
def test_is_distributed_env(environ, want):
    assert is_distributed_env(environ) is want


def test_a_model_axis_that_does_not_fit_one_device_raises(tmp_path):
    """The model axis is ported (tests/test_torch_tensor_parallel.py): in a
    process alone a model axis of 2 is a mesh that does not fit its one
    device, which every entry point refuses as the JAX package's
    ``create_mesh`` does."""
    from pixparse_tpu_torch.app.eval import main as eval_main
    from pixparse_tpu_torch.app.infer import main as infer_main
    from pixparse_tpu_torch.app.train import main as train_main

    no_fit = "1 devices not divisible by fsdp\\*model=2"
    with pytest.raises(ValueError, match=no_fit):
        MeshEnv.initialize(model=2, device="cpu")
    with pytest.raises(ValueError, match=no_fit):
        train_main(["--task.model_name", "cruller_test", "--task.device", "cpu",
                    "--task.mesh.model", "2", "--train.output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match=no_fit):
        eval_main(["--eval.task_name", "cruller_eval_ocr", "--task.model_name", "cruller_test",
                   "--task.device", "cpu", "--task.mesh.model", "2"])
    with pytest.raises(ValueError, match=no_fit):
        infer_main(["--task.model_name", "cruller_test", "--task.device", "cpu",
                    "--task.mesh.model", "2", "--infer.images", str(tmp_path)])


def test_a_process_alone_has_no_mesh_and_wraps_nothing(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    env = MeshEnv.initialize(device="cpu")
    assert env.mesh is None and env.world_size == 1 and env.global_rank == 0
    assert env.num_devices == 1 and env.is_primary()
    assert not torch.distributed.is_initialized()
    assert env.broadcast_object({"a": 1}) == {"a": 1}
    assert env.all_gather_object(3) == [3]
    batch = env.shard_batch({"x": np.ones((2, 3), np.float32), "d": {"y": np.arange(4)}})
    assert isinstance(batch["x"], torch.Tensor) and batch["d"]["y"].dtype == torch.int64
    assert "process 0/1" in str(env)
    env.close()  # no group to leave
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp"):
        MeshEnv.initialize(fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        MeshEnv.initialize(data=2, device="cpu")

    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.framework.optimization import create_optimizer
    from pixparse_tpu_torch.framework.train_state import create_train_state

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    optimizer, _ = create_optimizer(OptimizationCfg(), 1, 0, 1)
    state = create_train_state(model, optimizer, mesh=env.mesh)
    assert type(model) is torch.nn.Sequential  # not an FSDP class
    assert not any(mesh_mod.is_sharded(p) for p in state.params.values())
    assert state.params["0.weight"] is model[0].weight


def test_dropout_seed_rank_zero_is_the_process_alone():
    for seed, step, idx in [(1, 0, 0), (43, 7, 1), (2**40, 12345, 3)]:
        alone = dropout_seed(seed, step, idx)
        ranks = [dropout_seed(seed, step, idx, rank) for rank in range(8)]
        assert ranks[0] == alone and len(set(ranks)) == 8
        assert all(0 <= s < 2**63 for s in ranks)


@pytest.mark.parametrize("is_train", [True, False])
def test_dataset_loader_rank_stripes_equal_jax(is_train):
    """The indexable-dataset loader's split over 4 ranks of 10 items (uneven:
    3, 3, 2, 2) is JAX's, stripe for stripe and batch for batch, and the
    stripes cover the dataset once."""
    from pixparse_tpu.data.loader import HfDatasetLoader as JaxLoader
    from pixparse_tpu_torch.data.loader import HfDatasetLoader

    items = list(range(10))
    stripes = []
    for rank in range(4):
        kw = dict(dataset=items, batch_size=2, collate_fn=list, is_train=is_train, seed=3,
                  world_size=4, global_rank=rank)
        got, want = HfDatasetLoader(**kw), JaxLoader(**kw)
        for loader in (got, want):
            loader.set_interval(2)
        assert got._indices() == want._indices()
        assert len(got) == len(want)
        stripes.append(got._indices())
    assert sorted(i for s in stripes for i in s) == items
    assert [len(s) for s in stripes] == [3, 3, 2, 2]
