"""Adapter factory."""
from __future__ import annotations

from .abc import BaseAdapter
from .registry import resolve_adapter_class


def load_adapter(config, device=None) -> BaseAdapter:
    """Build the adapter of ``config.model_args.model_type`` on ``device``
    (default ``cuda``; a CUDA request without a card raises)."""
    return resolve_adapter_class(config.model_args.model_type)(config, device=device)
