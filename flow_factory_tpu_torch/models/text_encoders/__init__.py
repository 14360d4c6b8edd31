from .clip import CLIPTextConfig, CLIPTextEncoder, CLIPTextOutput, CLIPVisionConfig, CLIPVisionEncoder
from .lm import LMConfig, LMEncoder
from .t5 import T5Config, T5Encoder

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "CLIPTextOutput", "CLIPVisionConfig", "CLIPVisionEncoder",
           "LMConfig", "LMEncoder", "T5Config", "T5Encoder"]
