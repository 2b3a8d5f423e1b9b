"""Data config dataclasses (counterpart of :mod:`pixparse_tpu.data.config`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PreprocessCfg:
    # preprocessing is configured inside the tasks
    pass


@dataclass
class DatasetCfg:
    source: str
    num_samples: int
    batch_size: int
    split: str  # "train" | "test" | "val"
    format: str = "webdataset"  # or "hf_dataset"
    num_workers: int = 4


@dataclass
class DataCfg:
    train: Optional[DatasetCfg] = None
    eval: Optional[DatasetCfg] = None
