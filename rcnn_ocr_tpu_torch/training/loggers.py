"""The training loop's channels: a logger, TensorBoard scalars, a metrics CSV.

Counterpart of ``rcnn_ocr_tpu/training/loggers.py``: ``setup_logger``
(console plus ``exp_dir/train.log``), ``SummaryWriter`` (scalars through
the ``tensorboard`` package's event writer when it imports, else a no-op)
and ``MetricsCSV`` (the same header and rows).
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Optional


def setup_logger(exp_dir: str, name: str = "train") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    os.makedirs(exp_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(exp_dir, "train.log"), encoding="utf-8")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


class SummaryWriter:
    """Scalar-only TensorBoard writer; a no-op without ``tensorboard``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import EventFileWriter
        except ImportError:
            self._writer = None
            return
        self._Event, self._Summary = Event, Summary
        self._writer = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        summary = self._Summary(value=[self._Summary.Value(tag=tag, simple_value=float(value))])
        event = self._Event(summary=summary)
        event.wall_time = time.time()
        event.step = int(step)
        self._writer.add_event(event)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class MetricsCSV:
    """Appends one row per epoch; writes the header once."""

    HEADER = ["epoch", "train_loss", "val_loss", "val_acc", "val_cer", "val_wer", "lr"]

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            with open(path, "w", newline="", encoding="utf-8") as f:
                csv.writer(f).writerow(self.HEADER)

    def write_row(self, epoch: int, train_loss: float, lr: float,
                  val_loss: Optional[float] = None, val_acc: Optional[float] = None,
                  val_cer: Optional[float] = None, val_wer: Optional[float] = None) -> None:
        def fmt(v):
            return "skipped" if v is None else f"{v:.6f}"

        with open(self.path, "a", newline="", encoding="utf-8") as f:
            csv.writer(f).writerow([epoch, f"{train_loss:.6f}", fmt(val_loss), fmt(val_acc),
                                    fmt(val_cer), fmt(val_wer), f"{lr:.6e}"])
