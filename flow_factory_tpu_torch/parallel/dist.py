"""Process topology and host-side collectives for the PyTorch port.

The port reads the launcher's ``WORLD_SIZE`` and ``RANK`` (torchrun's names),
defaulting to one process of rank 0. Host collectives are the identity for
one process; more than one process raises until the multi-GPU slice lands.
There is no module-level override: tests set the environment instead
(``monkeypatch.setenv``), so nothing outlives a test.
"""
from __future__ import annotations

import os
from typing import Any, List

import numpy as np


def get_world_size() -> int:
    """Number of data-parallel replicas (one per process)."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def get_rank() -> int:
    return int(os.environ.get("RANK") or 0)


def get_num_processes() -> int:
    return get_world_size()


def is_distributed() -> bool:
    return get_num_processes() > 1


def _single_process(what: str) -> None:
    if is_distributed():
        raise NotImplementedError(
            f"{what} across {get_num_processes()} processes is not ported yet (multi-GPU slice)")


def host_allgather(x: np.ndarray) -> np.ndarray:
    """All-gather a host array across processes (axis-0 concat)."""
    _single_process("host_allgather")
    return np.asarray(x)


def host_allgather_objects(objs: List[Any]) -> List[List[Any]]:
    """Gather picklable objects from every process: one list per process."""
    _single_process("host_allgather_objects")
    return [list(objs)]
