"""Process topology and host-side collectives for the PyTorch port (JAX
``parallel/dist.py``).

One process drives one GPU. The launcher names the topology: torchrun's
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or the CLI's flags and their aliases
(``flow_factory_tpu_torch.cli.resolve_launch``). :func:`initialize_multihost`
makes the process group from them: NCCL for a run on the card, each process
bound to ``cuda:LOCAL_RANK``, and beside it one gloo group over every process
for the host collectives (numpy arrays and pickled objects); gloo alone when
the caller asks for the CPU (``device="cpu"``, as the tests do). A failed
initialisation raises. At one process with no launcher in the environment
nothing is made and every collective is the identity; above one process
without a group the collectives raise.

The host collectives run over the data-parallel processes of
:func:`install_data_topology` (by default every process): the ranks of one
``tensor`` group (``parallel/mesh.py``) hold the same rows, so each of them
gathers over the processes that share its tensor slot. Every call is counted
in :data:`COLLECTIVE_CALLS` by kind.
"""
from __future__ import annotations

import collections
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: collective calls of this process by kind ("host_allgather", "all_reduce",
#: "all_gather", "reduce_scatter", "p2p", "barrier"); reset by the caller
COLLECTIVE_CALLS: collections.Counter = collections.Counter()

#: the host (gloo) group over every process, and the data-parallel topology
#: the mesh installs
_STATE: Dict[str, Any] = {"host": None, "data_host": None, "data_size": None, "data_rank": None,
                          "device": None}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_num_processes() -> int:
    """Processes of the run: the process group's, else the launcher's ``WORLD_SIZE``."""
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE") or 1)


def get_rank() -> int:
    """This process's rank: the process group's, else the launcher's ``RANK``."""
    if _initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK") or 0)


def get_local_rank() -> int:
    """The GPU this process binds (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK") or 0)


def get_world_size(tensor_size: int = 1) -> int:
    """Number of data-parallel replicas: the mesh's replica x fsdp once a
    mesh is installed, else the processes over ``tensor_size`` (the ranks of
    a tensor group share rows)."""
    return _STATE["data_size"] or max(1, get_num_processes() // max(1, int(tensor_size or 1)))


def get_data_rank() -> int:
    """This process's data-parallel rank (its rows, samplers and rollout
    generators): the mesh's, else the process rank."""
    return get_rank() if _STATE["data_rank"] is None else _STATE["data_rank"]


def is_distributed() -> bool:
    """True when more than one process participates."""
    return get_num_processes() > 1


def collective_device() -> Optional[str]:
    """``"cuda"`` (NCCL) or ``"cpu"`` (gloo): where the device collectives of
    the process group run; None without a group."""
    return _STATE["device"] if _initialized() else None


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: Optional[str] = None) -> bool:
    """Make the process group (JAX ``initialize_multihost``, :87). The
    address, count and rank come from the arguments, else from torchrun's
    environment; without either (one process, no launcher) nothing is made
    and False returns. ``device`` "cpu" makes a gloo group; otherwise the
    process binds ``cuda:LOCAL_RANK`` and the group is NCCL, with a gloo
    group beside it for the host collectives. Raises when the group cannot
    be made; returns True once a group exists."""
    if _initialized():
        return True
    launched = "WORLD_SIZE" in os.environ or num_processes is not None
    if not launched and coordinator_address is None and process_id is None:
        return False
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE") or 1)
    rank = int(process_id if process_id is not None else os.environ.get("RANK") or 0)
    if coordinator_address:
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    else:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not host or not port:
            raise RuntimeError(f"initialize_multihost: {world} processes but no coordinator address: pass "
                               "--coordinator-address host:port or set MASTER_ADDR and MASTER_PORT")
        addr = f"tcp://{host}:{port}"
    if not 0 <= rank < world:
        raise ValueError(f"initialize_multihost: rank {rank} outside a world of {world}")
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: a CUDA process group was asked for but "
                               "torch.cuda.is_available() is False; pass device='cpu' for gloo")
        torch.cuda.set_device(get_local_rank())
        dist.init_process_group("nccl", init_method=addr, world_size=world, rank=rank)
        _STATE["host"] = dist.new_group(backend="gloo")
    elif kind == "cpu":
        dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
        _STATE["host"] = dist.group.WORLD
    else:
        raise ValueError(f"initialize_multihost: unsupported device {device!r}")
    _STATE["device"] = kind
    return True


def shutdown() -> None:
    """Destroy the process group and forget the topology (a no-op without one)."""
    if _initialized():
        dist.destroy_process_group()
    _STATE.update(host=None, data_host=None, data_size=None, data_rank=None, device=None)


def install_data_topology(data_size: int, data_rank: int, data_host_group) -> None:
    """Set by ``parallel.mesh.create_mesh``: the data-parallel size and rank
    and the gloo group of the processes that share this one's tensor slot."""
    _STATE.update(data_size=data_size, data_rank=data_rank, data_host=data_host_group)


def _host_group():
    """The gloo group of the host collectives, or None for the identity."""
    if get_num_processes() <= 1:
        return None
    if not _initialized():
        raise RuntimeError(f"{get_num_processes()} processes named by the environment but no process group: "
                           "call parallel.dist.initialize_multihost() first (fft-train-torch does)")
    return _STATE["data_host"] or _STATE["host"]


def _gather_objects(obj: Any) -> List[Any]:
    """One object per data-parallel process, in rank order (one gloo call)."""
    group = _host_group()
    if group is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    COLLECTIVE_CALLS["host_allgather"] += 1
    return out


def host_allgather(x: np.ndarray) -> np.ndarray:
    """All-gather a host array across processes (axis-0 concat, rank order).

    One process: the identity. The rows of each process may differ in
    number."""
    parts = _gather_objects(np.asarray(x))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def host_allgather_objects(objs: List[Any]) -> List[List[Any]]:
    """Gather picklable objects from every process: one list per process,
    indexed by process; one process gives ``[objs]``."""
    return [list(o) for o in _gather_objects(list(objs))]


def barrier(name: str) -> None:
    """Wait for every process (a no-op for one)."""
    if get_num_processes() <= 1:
        return
    if not _initialized():
        raise RuntimeError(f"barrier {name!r}: {get_num_processes()} processes named by the environment but no "
                           "process group: call parallel.dist.initialize_multihost() first")
    dist.barrier(group=_STATE["host"])
    COLLECTIVE_CALLS["barrier"] += 1


def _stats(v: np.ndarray) -> Dict[str, float]:
    """{mean, std, min, max} of one metric's values as JAX's packed
    (count, sum, sumsq, min, max) reduction gives them at one process."""
    n = max(float(v.size), 1.0)
    mean = (v.sum() if v.size else 0.0) / n
    var = max(((v * v).sum() if v.size else 0.0) / n - mean * mean, 0.0)
    return {"mean": float(mean), "std": float(var ** 0.5),
            "min": float(v.min()) if v.size else 0.0, "max": float(v.max()) if v.size else 0.0}


def global_tensor_stats_batch(metrics: dict) -> dict:
    """Global {min, max, mean, std} of N metrics in ONE gather (JAX
    ``global_tensor_stats_batch``, :141): every process's values of every
    metric in one host collective, then the statistics of the
    concatenation, so that they are the bits the JAX function gives at one
    process on the concatenated rows."""
    local = {name: np.asarray(metrics[name], np.float64).reshape(-1) for name in sorted(metrics)}
    parts = _gather_objects(local)
    return {name: _stats(np.concatenate([p[name] for p in parts])) for name in sorted(local)}


def reduce_loss_info(loss_info: dict) -> dict:
    """Cross-process metric reduction (JAX ``reduce_loss_info``, :180):
    per-sample vectors → flat ``metric`` (mean) and ``metric_{std,min,max}``
    keys; scalars → the global mean."""
    vectors = {k: v for k, v in loss_info.items() if np.asarray(v).size > 1}
    scalars = {k: v for k, v in loss_info.items() if k not in vectors}
    out: dict = {}
    stats = global_tensor_stats_batch({**scalars, **vectors}) if loss_info else {}
    for k in scalars:
        out[k] = stats[k]["mean"]
    for k in vectors:
        s = stats[k]
        out[k] = s["mean"]
        out[f"{k}_std"] = s["std"]
        out[f"{k}_min"] = s["min"]
        out[f"{k}_max"] = s["max"]
    return dict(sorted(out.items()))


def global_stats(values: np.ndarray) -> tuple:
    """Global (mean, std) across processes (JAX ``global_stats``, :201), the
    std floored at 1e-6."""
    values = np.concatenate([np.asarray(p, np.float64).reshape(-1) for p in _gather_objects(np.asarray(values))])
    n, s, ss = float(values.size), values.sum(), (values ** 2).sum()
    mean = s / max(n, 1)
    std = max((ss / max(n, 1) - mean ** 2), 0.0) ** 0.5
    return float(mean), float(max(std, 1e-6))
