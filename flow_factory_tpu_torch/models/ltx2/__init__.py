from .audio import AudioVAE, AudioVAEConfig
from .i2av import LTX2I2AVAdapter
from .t2av import LTX2T2AVAdapter
from .transformer import LTX2Config, LTX2Transformer
from .video_vae import LTXVideoVAE, LTXVideoVAEConfig

__all__ = ["LTX2T2AVAdapter", "LTX2I2AVAdapter", "LTX2Config", "LTX2Transformer", "AudioVAE", "AudioVAEConfig",
           "LTXVideoVAE", "LTXVideoVAEConfig"]
