"""Training loggers (port of ``flow_factory_tpu/logger/logger.py``, scalars
only): the console and the append-only ``metrics.jsonl`` record, which the
``none`` backend runs. wandb, swanlab and tensorboard are not ported and
raise; image and video logging are not ported."""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List

import numpy as np

logger = logging.getLogger(__name__)


class ConsoleLogger:
    def __init__(self, log_args, run_name: str):
        self.run_name = run_name

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        scalars = {k: round(float(v), 5) for k, v in data.items() if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        logger.info("[step %d] %s", step, json.dumps(scalars, sort_keys=True))


class JSONLLogger:
    """Append-only metrics file — the machine-readable run record."""

    def __init__(self, log_args, run_name: str):
        out_dir = os.path.join(getattr(log_args, "save_dir", "saves"), run_name)
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in data.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class MultiLogger:
    def __init__(self, backends: List[Any]):
        self.backends = backends

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        for b in self.backends:
            b.log_data(data, step)


def load_logger(log_args, run_name: str) -> MultiLogger:
    backend = getattr(log_args, "logging_backend", "none")
    if backend not in (None, "none"):
        raise NotImplementedError(f"logging backend {backend!r} is not ported yet; use 'none' "
                                  "(console and metrics.jsonl)")
    return MultiLogger([ConsoleLogger(log_args, run_name), JSONLLogger(log_args, run_name)])
