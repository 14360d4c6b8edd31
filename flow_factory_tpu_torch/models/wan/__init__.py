"""Wan 2.x: the video DiT, the causal video VAE, and the T2V, I2V and V2V adapters."""
from .i2v import WanI2VAdapter, WanV2VAdapter
from .t2v import WanT2VAdapter
from .transformer import WanConfig, WanTransformer
from .video_vae import VideoVAE, VideoVAEConfig

__all__ = ["VideoVAE", "VideoVAEConfig", "WanConfig", "WanI2VAdapter", "WanT2VAdapter", "WanTransformer",
           "WanV2VAdapter"]
