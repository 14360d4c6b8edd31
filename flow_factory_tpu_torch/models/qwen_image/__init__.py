"""Qwen-Image and Qwen-Image-Edit-Plus."""
from .adapter import QwenImageAdapter
from .edit_plus import QwenImageEditPlusAdapter

__all__ = ["QwenImageAdapter", "QwenImageEditPlusAdapter"]
