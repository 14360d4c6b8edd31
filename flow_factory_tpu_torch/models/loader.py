"""Adapter factory."""
from __future__ import annotations

from .abc import BaseAdapter
from .registry import resolve_adapter_class


def load_adapter(config, device=None, mesh=None) -> BaseAdapter:
    """Build the adapter of ``config.model_args.model_type`` on ``device``
    (default ``cuda``; a CUDA request without a card raises), over ``mesh``
    (``parallel/mesh.py``) when one is given."""
    return resolve_adapter_class(config.model_args.model_type)(config, device=device, mesh=mesh)
