from .ema import EMA, constant_decay, get_decay_schedule, tree_map

__all__ = ["EMA", "constant_decay", "get_decay_schedule", "tree_map"]
