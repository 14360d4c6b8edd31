from .clip import CLIPTextConfig, CLIPTextEncoder, CLIPTextOutput
from .lm import LMConfig, LMEncoder
from .t5 import T5Config, T5Encoder

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "CLIPTextOutput", "LMConfig", "LMEncoder", "T5Config", "T5Encoder"]
