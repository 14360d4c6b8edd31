from .clip import CLIPTextConfig, CLIPTextEncoder, CLIPTextOutput
from .t5 import T5Config, T5Encoder

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "CLIPTextOutput", "T5Config", "T5Encoder"]
