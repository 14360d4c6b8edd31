"""Wan V2V adapter (a re-export: it lives in i2v.py beside the I2V adapter, as in the JAX package)."""
from .i2v import WanV2VAdapter

__all__ = ["WanV2VAdapter"]
