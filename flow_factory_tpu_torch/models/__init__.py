from .abc import BaseAdapter
from .loader import load_adapter
from .registry import resolve_adapter_class

__all__ = ["BaseAdapter", "load_adapter", "resolve_adapter_class"]
