"""Z-Image: the single-stream S3-DiT and its adapter."""
from .adapter import ZImageAdapter
from .transformer import ZImageConfig, ZImageTransformer

__all__ = ["ZImageAdapter", "ZImageConfig", "ZImageTransformer"]
