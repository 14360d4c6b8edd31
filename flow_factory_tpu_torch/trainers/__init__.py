from .abc import BaseTrainer
from .loader import load_trainer
from .registry import resolve_trainer_class

__all__ = ["BaseTrainer", "load_trainer", "resolve_trainer_class"]
