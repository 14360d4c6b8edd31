from .logger import (
    BaseLogger,
    ConsoleLogger,
    JSONLLogger,
    MultiLogger,
    TensorboardLogger,
    WandbLogger,
    load_logger,
)

__all__ = [
    "BaseLogger",
    "ConsoleLogger",
    "JSONLLogger",
    "TensorboardLogger",
    "WandbLogger",
    "MultiLogger",
    "load_logger",
]
