from .advantage_processor import AdvantageProcessor

__all__ = ["AdvantageProcessor"]
