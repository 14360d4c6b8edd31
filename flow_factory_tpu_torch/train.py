"""Training entry point: ``python -m flow_factory_tpu_torch.train <config.yaml> [--device cpu]``.

Runs on ``cuda`` unless ``--device`` or the config's ``model.device`` asks
for another device (``cpu`` runs every kernel's plain PyTorch version). The
config may be YAML or JSON. ``fft-train-torch`` (:mod:`.cli`) is the
launcher that takes overrides.
"""
from __future__ import annotations

import argparse
import logging
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flow_factory_tpu_torch.train")
    parser.add_argument("config", help="the training YAML (or JSON)")
    parser.add_argument("--device", default=None, help="default: the config's model.device, else cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from .hparams.args import Arguments
    from .trainers import load_trainer
    from .utils.base import use_full_fp32

    use_full_fp32()
    trainer = load_trainer(Arguments.load_from_yaml(args.config), device=args.device)
    try:
        trainer.start()
    except KeyboardInterrupt:
        logging.getLogger(__name__).info("Interrupted; cleaning up")
        trainer.cleanup()
        os._exit(0)


if __name__ == "__main__":
    main()
