"""Metrics and log fan-out (the port's own copy of
:mod:`pixparse_tpu.framework.monitor`).

Console line, CSV summary, TensorBoard and wandb, all gated to the primary
process via ``output_enabled``. TensorBoard goes through
``torch.utils.tensorboard``; wandb is optional. Both are imported only when
asked for, inside :class:`Monitor`.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import OrderedDict
from typing import Any, Dict, Optional

_logger = logging.getLogger(__name__)


def _to_display_image(v):
    """Normalized float (H, W, C) array -> display uint8 (H, W, C); None for
    non-image values."""
    import numpy as np

    arr = np.asarray(v)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.dtype.kind not in "fiu":
        return None
    if arr.dtype.kind == "f":
        lo, hi = float(arr.min()), float(arr.max())
        arr = (arr - lo) / (hi - lo + 1e-8) * 255.0
    arr = arr.clip(0, 255).astype("uint8")
    if arr.shape[2] == 1:
        arr = arr.repeat(3, axis=2)
    return arr


def summary_row_dict(results: Dict[str, Any], index=None, index_name="epoch") -> Dict[str, Any]:
    """Flatten per-phase nested dicts to one CSV row."""
    row = OrderedDict()
    if index is not None:
        row[index_name] = index
    for k, v in results.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                row[f"{k}_{kk}"] = vv
        else:
            row[k] = v
    return row


class SummaryCsv:
    """Append-with-header CSV writer."""

    def __init__(self, output_dir: str, filename: str = "summary.csv"):
        self.output_dir = output_dir
        self.filename = os.path.join(output_dir, filename)
        self.needs_header = not os.path.exists(self.filename)

    def update(self, row_dict: Dict[str, Any]):
        with open(self.filename, mode="a") as cf:
            dw = csv.DictWriter(cf, fieldnames=row_dict.keys())
            if self.needs_header:
                dw.writeheader()
                self.needs_header = False
            dw.writerow(row_dict)


class Monitor:
    def __init__(
        self,
        experiment_name: Optional[str] = None,
        output_dir: Optional[str] = None,
        logger: Optional[logging.Logger] = None,
        hparams: Optional[dict] = None,
        wandb: bool = False,
        wandb_project: str = "pixparse-tpu-torch",
        wandb_dir: str = "wandb",
        tensorboard: bool = False,
        tensorboard_dir: str = "tensorboard",
        output_enabled: bool = True,
        log_eval_data: bool = False,
    ):
        self.experiment_name = experiment_name
        self.output_dir = output_dir
        self.logger = logger or _logger
        self.output_enabled = output_enabled
        self.log_eval_data = log_eval_data
        self.csv_writer = SummaryCsv(output_dir) if (output_dir and output_enabled) else None

        self.tb_writer = None
        if tensorboard and output_enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb_path = (
                    os.path.join(output_dir, tensorboard_dir) if output_dir else tensorboard_dir
                )
                self.tb_writer = SummaryWriter(tb_path)
            except ImportError:
                self.logger.warning(
                    "tensorboard requested but torch.utils.tensorboard unavailable"
                )

        self.wandb_run = None
        if wandb and output_enabled:
            try:
                import wandb as wandb_mod

                self.wandb_run = wandb_mod.init(
                    project=wandb_project,
                    name=experiment_name,
                    config=hparams,
                    dir=wandb_dir,
                )
            except ImportError:
                self.logger.warning("wandb requested but not installed")

    # ------------------------------------------------------------------
    def log_step(
        self,
        phase: str,
        step_idx: int,
        step_end_idx: Optional[int] = None,
        interval: Optional[int] = None,
        loss: Optional[float] = None,
        rate: Optional[float] = None,
        lr: Optional[float] = None,
        phase_suffix: str = "",
        metrics: Optional[Dict[str, Any]] = None,
        eval_data: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        """One training/eval step line + scalars."""
        if not self.output_enabled:
            return
        topic = f"{phase}" + (f"/{phase_suffix}" if phase_suffix else "")
        progress = (
            100.0 * step_idx / step_end_idx if step_end_idx else 0.0
        )
        text = [f"{phase.capitalize()}"]
        if interval is not None:
            text.append(f"interval: {interval}")
        text.append(f"[{step_idx}" + (f"/{step_end_idx} ({progress:.0f}%)]" if step_end_idx else "]"))
        if rate is not None:
            text.append(f"rate: {rate:.2f} samples/s")
        if loss is not None:
            text.append(f"loss: {loss:.5f}")
        if lr is not None:
            text.append(f"lr: {lr:.2e}")
        if metrics:
            text.extend(f"{k}: {v}" for k, v in metrics.items())
        self.logger.info("  ".join(text))

        if self.tb_writer is not None:
            if loss is not None:
                self.tb_writer.add_scalar(f"loss/{topic}", loss, step_idx)
            if lr is not None:
                self.tb_writer.add_scalar(f"learning_rate/{topic}", lr, step_idx)
            if rate is not None:
                self.tb_writer.add_scalar(f"rate/{topic}", rate, step_idx)
            for k, v in (metrics or {}).items():
                if isinstance(v, (int, float)):
                    self.tb_writer.add_scalar(f"{k}/{topic}", v, step_idx)
            if eval_data and self.log_eval_data:
                for k, v in eval_data.items():
                    if isinstance(v, str):
                        self.tb_writer.add_text(f"{k}/{topic}", v, step_idx)
                    else:
                        img = _to_display_image(v)
                        if img is not None:
                            # OCR gallery
                            self.tb_writer.add_image(
                                f"{k}/{topic}", img, step_idx, dataformats="HWC"
                            )

        if self.wandb_run is not None:
            row = {"step": step_idx}
            if loss is not None:
                row[f"{topic}/loss"] = loss
            if lr is not None:
                row[f"{topic}/lr"] = lr
            if rate is not None:
                row[f"{topic}/rate"] = rate
            for k, v in (metrics or {}).items():
                if isinstance(v, (int, float)):
                    row[f"{topic}/{k}"] = v
            self.wandb_run.log(row)

    def log_phase(
        self,
        phase: str = "eval",
        interval: Optional[int] = None,
        name_prefix: str = "",
        **kwargs,
    ):
        if not self.output_enabled:
            return
        name = f"{name_prefix}{phase}"
        self.logger.info(
            f"Phase {name} done" + (f" (interval {interval})" if interval is not None else "")
        )

    def write_summary(self, results: Dict[str, Any], index=None, index_name="interval"):
        """CSV row + wandb summary."""
        if not self.output_enabled:
            return
        row = summary_row_dict(results, index=index, index_name=index_name)
        if self.csv_writer:
            self.csv_writer.update(row)
        if self.wandb_run is not None:
            self.wandb_run.log(row)

    def close(self):
        if self.tb_writer is not None:
            self.tb_writer.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()
