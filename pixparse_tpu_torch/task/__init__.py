"""Task layer: the nine Cruller tasks, pix2struct pretraining, the Donut
baseline and the factory (counterpart of :mod:`pixparse_tpu.task`)."""

from pixparse_tpu_torch.task.task_cruller_eval_cord import (
    TaskCrullerEvalCORD,
    TaskCrullerEvalCORDCfg,
)
from pixparse_tpu_torch.task.task_cruller_eval_docvqa import (
    TaskCrullerEvalDOCVQA,
    TaskCrullerEvalDOCVQACfg,
)
from pixparse_tpu_torch.task.task_cruller_eval_ocr import (
    TaskCrullerEvalOCR,
    TaskCrullerEvalOCRCfg,
)
from pixparse_tpu_torch.task.task_cruller_eval_rvlcdip import (
    TaskCrullerEvalRVLCDIP,
    TaskCrullerEvalRVLCDIPCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_cord import (
    TaskCrullerFinetuneCORD,
    TaskCrullerFinetuneCORDCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_docvqa import (
    TaskCrullerFinetuneDOCVQA,
    TaskCrullerFinetuneDOCVQACfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_rvlcdip import (
    TaskCrullerFinetuneRVLCDIP,
    TaskCrullerFinetuneRVLCDIPCfg,
)
from pixparse_tpu_torch.task.task_cruller_finetune_xent import (
    TaskCrullerFinetuneXent,
    TaskCrullerFinetuneXentCfg,
)
from pixparse_tpu_torch.task.task_cruller_pretrain import (
    TaskCrullerPretrain,
    TaskCrullerPretrainCfg,
)
from pixparse_tpu_torch.task.task_donut_eval_ocr import TaskDonutEvalOCR, TaskDonutEvalOCRCfg
from pixparse_tpu_torch.task.task_pix2struct_pretrain import (
    TaskPix2StructPretrain,
    TaskPix2StructPretrainCfg,
)
from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
