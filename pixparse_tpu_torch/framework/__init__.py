"""Framework layer (counterpart of :mod:`pixparse_tpu.framework`)."""

from pixparse_tpu_torch.framework.config import TaskEvalCfg
from pixparse_tpu_torch.framework.logger import setup_logging
from pixparse_tpu_torch.framework.random import random_seed
from pixparse_tpu_torch.framework.task import Task, TaskEval
