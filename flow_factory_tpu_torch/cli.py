"""Command-line launcher: ``fft-train-torch config.yaml [--set KEY=VALUE ...] [--a.b value ...]``.

Port of ``flow_factory_tpu/cli.py``: the config file, then the overrides —
``--set train.learning_rate=1e-4`` and bare ``--train.learning_rate 1e-4``
pairs, each value read by ``yaml.safe_load`` — then the trainer, in this
process, on ``cuda`` unless the config's ``model.device`` asks for another
device (``--set model.device=cpu``). fp32 math runs in full fp32
(``utils.base.use_full_fp32``). ``python -m flow_factory_tpu_torch.cli`` is
the same entry point.

Several GPUs: one process each, joined in one process group
(``parallel.dist.initialize_multihost``; NCCL on the card, gloo with
``model.device=cpu``) over the mesh of ``model.fsdp_size`` and
``model.tensor_size`` (``parallel/mesh.py``). The topology comes from
torchrun's environment (``torchrun --nproc_per_node N -m
flow_factory_tpu_torch.cli config.yaml``: ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else from the flags
``--coordinator-address host:port``, ``--process-id`` and
``--num-processes``, else from the JAX launcher's aliases (one process a
node, binding GPU ``LOCAL_RANK`` or 0):
  coordinator:  COORDINATOR_ADDRESS | MASTER_IP | MASTER_ADDR | CHIEF_IP
  process id:   PROCESS_ID | MACHINE_RANK | NODE_RANK | INDEX
  num hosts:    NUM_PROCESSES | NUM_MACHINES | NUM_NODES | HOST_NUM
An address without a port takes ``MASTER_PORT`` or 29500. ``tensor_size``
above 1 without ``attn_backend: ring`` raises before any group is made
(tensor parallelism is not ported, ROADMAP Queue 1 item 22).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, List, Optional

import yaml

logger = logging.getLogger(__name__)

_ENV_ALIASES = {
    "coordinator_address": ("COORDINATOR_ADDRESS", "MASTER_IP", "MASTER_ADDR", "CHIEF_IP"),
    "process_id": ("PROCESS_ID", "MACHINE_RANK", "NODE_RANK", "INDEX"),
    "num_processes": ("NUM_PROCESSES", "NUM_MACHINES", "NUM_NODES", "HOST_NUM"),
}


def resolve_multihost_env() -> Dict[str, Optional[str]]:
    out: Dict[str, Optional[str]] = {}
    for key, names in _ENV_ALIASES.items():
        out[key] = next((os.environ[n] for n in names if os.environ.get(n)), None)
    return out


def resolve_launch(coordinator_address: Optional[str] = None, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> Dict[str, Any]:
    """The run's (coordinator_address, process_id, num_processes): each flag
    given, else torchrun's ``MASTER_ADDR:MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``, else the first alias set; an address gets
    ``MASTER_PORT`` (or 29500) when it names no port. ``num_processes`` None
    means no launcher: one process."""
    env = resolve_multihost_env()
    torchrun = "WORLD_SIZE" in os.environ
    addr = coordinator_address or (
        os.environ.get("MASTER_ADDR") if torchrun else None) or env["coordinator_address"]
    if addr and ":" not in addr.split("://")[-1]:
        addr = f"{addr}:{os.environ.get('MASTER_PORT') or 29500}"
    if process_id is None:
        raw = os.environ.get("RANK") if torchrun else env["process_id"]
        process_id = int(raw) if raw else None
    if num_processes is None:
        raw = os.environ.get("WORLD_SIZE") if torchrun else env["num_processes"]
        num_processes = int(raw) if raw else None
    return {"coordinator_address": addr, "process_id": process_id, "num_processes": num_processes}


def _set_nested(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def train_cli(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="fft-train-torch", description="Flow-Factory trainer launcher (PyTorch)")
    parser.add_argument("config", help="YAML config file")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="dotted config override, e.g. --set train.learning_rate=1e-4",
    )
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    args, unknown = parser.parse_known_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    with open(args.config) as f:
        cfg: Dict[str, Any] = yaml.safe_load(f) or {}

    # the flags, then torchrun's environment, then the aliases name the topology
    launch = resolve_launch(args.coordinator_address, args.process_id, args.num_processes)

    for ov in args.overrides:
        if "=" not in ov:
            raise SystemExit(f"--set expects KEY=VALUE, got {ov!r}")
        k, v = ov.split("=", 1)
        _set_nested(cfg, k, _parse_value(v))
    # also accept bare --a.b.c value pairs
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if tok.startswith("--") and i + 1 < len(unknown):
            _set_nested(cfg, tok[2:], _parse_value(unknown[i + 1]))
            i += 2
        else:
            i += 1

    from .parallel.mesh import refuse_tensor_parallelism

    model = cfg.get("model") or {}  # refused before any process group is made
    refuse_tensor_parallelism(model.get("tensor_size", 1), model.get("attn_backend", "auto"))

    import torch.distributed as dist

    from .hparams.args import Arguments
    from .parallel.dist import COLLECTIVE_CALLS, initialize_multihost, shutdown
    from .trainers import load_trainer
    from .utils.base import use_full_fp32

    if launch["num_processes"] is not None and (launch["num_processes"] > 1 or launch["coordinator_address"]):
        initialize_multihost(launch["coordinator_address"], launch["num_processes"], launch["process_id"],
                             device=(cfg.get("model") or {}).get("device"))
    use_full_fp32()
    config = Arguments.from_dict(cfg)
    config.config_file = args.config
    try:
        trainer = load_trainer(config)
        try:
            trainer.start()
        except KeyboardInterrupt:
            trainer.cleanup()
            os._exit(0)
        if dist.is_initialized():
            logger.info("collective calls of rank %d (backend %s, world %d): %s", dist.get_rank(), dist.get_backend(),
                        dist.get_world_size(), dict(sorted(COLLECTIVE_CALLS.items())))
    finally:
        shutdown()


if __name__ == "__main__":
    train_cli()
