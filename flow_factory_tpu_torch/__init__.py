"""PyTorch/CUDA port of flow_factory_tpu for NVIDIA Hopper.

Imports ``torch`` and numpy only — never ``jax`` or the JAX package. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; kernel
wrappers launch their hand-written kernel on a CUDA tensor and take the
plain PyTorch version only for a CPU tensor.
"""
__version__ = "0.1.0"
