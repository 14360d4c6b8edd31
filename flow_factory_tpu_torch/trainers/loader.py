"""Trainer factory: the adapter on its device, then the trainer."""
from __future__ import annotations

from ..models import load_adapter
from .registry import resolve_trainer_class


def load_trainer(config, device=None):
    """The trainer of ``config.training_args.trainer_type`` over the adapter
    of ``config.model_args.model_type``, on ``device``, else on the config's
    ``model.device``, else on ``cuda`` (a CUDA request without a card raises)."""
    device = device or getattr(config.model_args, "device", None)
    adapter = load_adapter(config, device=device)
    return resolve_trainer_class(config.training_args.trainer_type)(config, adapter)
