"""Training logs: a file-and-stream logger, windowed metric averages, a
JSONL metrics stream and an optional experiment tracker.

Port of pixart_sigma_tpu/utils/logging.py. Files, metrics and the tracker
are written by rank 0 only; the other ranks log errors to the stream.
`Tracker` writes
scalars and validation images to TensorBoard (`report_to="tensorboard"`);
a backend that is not installed, or any other name, raises and names itself,
where the JAX package warns and goes on without it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

from pixart_sigma_tpu_torch.parallel.dist import is_main_process


def get_logger(work_dir: str) -> logging.Logger:
    """A logger for one run: INFO to the stream and to work_dir/train.log on
    rank 0; errors only, to the stream, on the other ranks."""
    logger = logging.getLogger(f"pixart_sigma_tpu_torch.trainer.{work_dir}")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
        stream = logging.StreamHandler()
        handlers = [stream]
        if is_main_process():
            os.makedirs(work_dir, exist_ok=True)
            handlers.append(logging.FileHandler(os.path.join(work_dir, "train.log")))
        else:
            stream.setLevel(logging.ERROR)
        for handler in handlers:
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger


class LogBuffer:
    """Windowed averages of scalar metrics (mmcv LogBuffer semantics)."""

    def __init__(self) -> None:
        self._vals: Dict[str, list] = defaultdict(list)
        self.output: Dict[str, float] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._vals[k].append(float(v))

    def average(self) -> None:
        self.output = {k: sum(v) / max(1, len(v)) for k, v in self._vals.items()}

    def clear(self) -> None:
        self._vals.clear()


class MetricsWriter:
    """Append-only JSONL metrics: one {"step", "time", metrics...} per line,
    written by rank 0."""

    def __init__(self, work_dir: str, filename: str = "metrics.jsonl"):
        self.path = os.path.join(work_dir, filename)
        self.enabled = is_main_process()
        if self.enabled:
            os.makedirs(work_dir, exist_ok=True)

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class Tracker:
    """Scalars and validation images to TensorBoard under work_dir/tb, from
    rank 0."""

    def __init__(self, work_dir: str, report_to: Optional[str] = None):
        self._writer = None
        if not report_to:
            return
        if report_to != "tensorboard":
            raise ValueError(f"report_to={report_to!r}: only 'tensorboard' is supported")
        if not is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(f"report_to='tensorboard' needs the tensorboard package: {e}"
                              ) from e
        self._writer = SummaryWriter(log_dir=os.path.join(work_dir, "tb"))

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def add_scalars(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(v), global_step=step)

    def add_images(self, step: int, tag: str, images) -> None:
        """images: [N, H, W, C] float in [0, 1]."""
        if self._writer is not None:
            self._writer.add_images(tag, images, global_step=step, dataformats="NHWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
