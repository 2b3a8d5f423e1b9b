"""Framework layer (counterpart of :mod:`pixparse_tpu.framework`)."""

from pixparse_tpu_torch.framework.config import MeshCfg, OptimizationCfg, TaskEvalCfg, TaskTrainCfg
from pixparse_tpu_torch.framework.eval import evaluate
from pixparse_tpu_torch.framework.logger import setup_logging
from pixparse_tpu_torch.framework.monitor import Monitor
from pixparse_tpu_torch.framework.random import random_seed
from pixparse_tpu_torch.framework.task import StopTraining, Task, TaskEval, TaskTrain
from pixparse_tpu_torch.framework.train import train_one_interval
from pixparse_tpu_torch.parallel.mesh import MeshEnv
