from .adapter import SD35Adapter
from .transformer import MMDiTConfig, SD3Transformer

__all__ = ["SD35Adapter", "MMDiTConfig", "SD3Transformer"]
