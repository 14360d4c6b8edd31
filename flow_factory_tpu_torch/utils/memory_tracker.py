"""Opt-in memory profiling and the profiler trace.

Port of ``flow_factory_tpu/utils/memory_tracker.py``, with the same opt-in
shape on PyTorch's sources:

* parameter, tensor and optimizer-state sizes as sums of ``nbytes`` over the
  tensors and arrays of nested dicts, lists and tuples;
* device memory per stage from ``torch.cuda.memory_allocated`` /
  ``max_memory_allocated`` / ``memory_reserved`` (all 0 on the CPU), and,
  with ``profile_dir`` or ``FFT_MEMORY_PROFILE_DIR`` set, a pickled
  ``torch.cuda.memory_snapshot()`` a stage for attribution;
* :func:`trace`, a ``torch.profiler`` session written as a gzipped chrome
  trace (open it in Perfetto or ``chrome://tracing``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import pickle
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor and array in nested dicts, lists and tuples (an
    optimizer's ``state_dict()`` included)."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


def _fmt(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}TiB"


class ModelMemoryTracker:
    """Parameter/buffer footprint per component."""

    def __init__(self):
        self.components: Dict[str, int] = {}

    def track(self, name: str, params: Any) -> int:
        n = tree_nbytes(params)
        self.components[name] = n
        return n

    def report(self) -> Dict[str, str]:
        return {k: _fmt(v) for k, v in self.components.items()}


class TensorMemoryTracker:
    """Per-stage accumulation of tensor bytes (the rollout samples' arrays)."""

    def __init__(self):
        self.stages: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)

    def track(self, stage: str, tree: Any) -> None:
        self.stages[stage] += tree_nbytes(tree)
        self.counts[stage] += 1

    def track_samples(self, stage: str, samples: List[Any]) -> None:
        total = 0
        for s in samples:
            for v in getattr(s, "asdict", dict)().values() if hasattr(s, "asdict") else []:
                if isinstance(v, np.ndarray):
                    total += v.nbytes
        self.stages[stage] += total
        self.counts[stage] += len(samples)

    def report(self) -> Dict[str, str]:
        return {k: f"{_fmt(v)} ({self.counts[k]}x)" for k, v in self.stages.items()}


class OptimizerMemoryTracker:
    def __init__(self):
        self.size = 0

    def track(self, opt_state: Any) -> int:
        self.size = tree_nbytes(opt_state)
        return self.size

    def report(self) -> Dict[str, str]:
        return {"optimizer_state": _fmt(self.size)}


class DeviceMemoryTracker:
    """Device memory snapshots per stage: bytes allocated now and at the peak,
    reserved by the caching allocator, and the card's total; 0 without a
    card. With a ``profile_dir`` each snapshot also pickles the allocator's
    ``memory_snapshot()`` (its segments and blocks) for attribution."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.snapshots: Dict[str, Dict[str, int]] = {}
        self.profile_dir = profile_dir or os.environ.get("FFT_MEMORY_PROFILE_DIR")

    def snapshot(self, stage: str) -> Dict[str, int]:
        cuda = torch.cuda.is_available()
        stats = {
            "bytes_in_use": torch.cuda.memory_allocated() if cuda else 0,
            "peak_bytes_in_use": torch.cuda.max_memory_allocated() if cuda else 0,
            "bytes_reserved": torch.cuda.memory_reserved() if cuda else 0,
            "bytes_limit": torch.cuda.get_device_properties(0).total_memory if cuda else 0,
        }
        if self.profile_dir and cuda:
            try:
                os.makedirs(self.profile_dir, exist_ok=True)
                fname = os.path.join(self.profile_dir, stage.replace("/", "_") + ".memsnapshot.pickle")
                with open(fname, "wb") as f:
                    pickle.dump(torch.cuda.memory_snapshot(), f)
                stats["profile_bytes"] = os.path.getsize(fname)
            except Exception as e:  # profiling must never break training
                logger.debug("memory_snapshot failed at %s: %s", stage, e)
        self.snapshots[stage] = stats
        return stats

    def report(self) -> Dict[str, str]:
        return {stage: " ".join(f"{k}={_fmt(v)}" for k, v in s.items()) for stage, s in self.snapshots.items()}


class MemoryProfiler:
    """Facade bundling all trackers."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.model = ModelMemoryTracker()
        self.tensors = TensorMemoryTracker()
        self.optimizer = OptimizerMemoryTracker()
        self.device = DeviceMemoryTracker()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        self.device.snapshot(f"{name}/enter")
        t0 = time.perf_counter()
        yield
        self.device.snapshot(f"{name}/exit")
        logger.info("[memory] stage %s took %.3fs", name, time.perf_counter() - t0)

    def report(self) -> Dict[str, Dict[str, str]]:
        return {
            "model": self.model.report(),
            "tensors": self.tensors.report(),
            "optimizer": self.optimizer.report(),
            "device": self.device.report(),
        }

    def log_report(self) -> None:
        for section, rows in self.report().items():
            for k, v in rows.items():
                logger.info("[memory] %s/%s: %s", section, k, v)


@contextlib.contextmanager
def trace(log_dir: str = "fft_trace", annotate: Optional[str] = None):
    """A ``torch.profiler`` session over the block (the host, and the card
    when there is one), written to ``<log_dir>/<annotate or 'trace'>.pt.trace.json.gz``;
    ``annotate`` also names a ``record_function`` range around the block."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    path = os.path.join(log_dir, f"{annotate or 'trace'}.pt.trace.json.gz")
    prof = profile(activities=activities)
    try:
        with prof, (record_function(annotate) if annotate else contextlib.nullcontext()):
            yield log_dir
    finally:
        prof.export_chrome_trace(path)
        logger.info("Profiler trace written to %s", path)
