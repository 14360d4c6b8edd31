"""Command-line launcher: ``fft-train-torch config.yaml [--set KEY=VALUE ...] [--a.b value ...]``.

Port of ``flow_factory_tpu/cli.py``: the config file, then the overrides —
``--set train.learning_rate=1e-4`` and bare ``--train.learning_rate 1e-4``
pairs, each value read by ``yaml.safe_load`` — then the trainer, in this
process, on ``cuda`` unless the config's ``model.device`` asks for another
device (``--set model.device=cpu``). fp32 math runs in full fp32
(``utils.base.use_full_fp32``). ``python -m flow_factory_tpu_torch.cli`` is
the same entry point.

The port runs one process. More than one raises (ROADMAP Queue 1 item 11):
``--num-processes`` or the launcher's environment (any alias)
  num hosts:    NUM_PROCESSES | NUM_MACHINES | NUM_NODES | HOST_NUM
above 1, and ``--coordinator-address`` or ``--process-id``, which only a
multi-process run needs.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, List, Optional

import yaml

_ENV_ALIASES = {
    "num_processes": ("NUM_PROCESSES", "NUM_MACHINES", "NUM_NODES", "HOST_NUM"),
}


def resolve_multihost_env() -> Dict[str, Optional[str]]:
    out: Dict[str, Optional[str]] = {}
    for key, names in _ENV_ALIASES.items():
        out[key] = next((os.environ[n] for n in names if os.environ.get(n)), None)
    return out


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

    # the environment, then the flags, name the topology
    env = resolve_multihost_env()
    num_processes = args.num_processes if args.num_processes is not None else (
        int(env["num_processes"]) if env["num_processes"] else None
    )

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

    if (num_processes and num_processes > 1) or args.coordinator_address or args.process_id is not None:
        raise NotImplementedError(
            f"{num_processes or 'several'} processes (coordinator {args.coordinator_address}, process id "
            f"{args.process_id}): multi-GPU training is not ported yet (ROADMAP Queue 1 item 11)")

    from .hparams.args import Arguments
    from .trainers import load_trainer
    from .utils.base import use_full_fp32

    use_full_fp32()
    config = Arguments.from_dict(cfg)
    config.config_file = args.config
    trainer = load_trainer(config)
    try:
        trainer.start()
    except KeyboardInterrupt:
        trainer.cleanup()
        os._exit(0)


if __name__ == "__main__":
    train_cli()
