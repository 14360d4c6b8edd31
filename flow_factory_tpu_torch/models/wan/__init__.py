"""Wan 2.1 text-to-video: the video DiT, the causal video VAE and the adapter."""
from .transformer import WanConfig, WanTransformer
from .video_vae import VideoVAE, VideoVAEConfig

__all__ = ["VideoVAE", "VideoVAEConfig", "WanConfig", "WanTransformer"]
