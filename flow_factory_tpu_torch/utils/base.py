"""Core glue utilities (port of ``flow_factory_tpu/utils/base.py``).

Deterministic seeds come from stable hashes of arbitrary parts; the port turns
them into explicit ``torch.Generator`` objects instead of JAX keys. Devices
are explicit: entry points default to ``cuda`` and never fall back to the CPU.
"""
from __future__ import annotations

import hashlib
from typing import Any, Iterable, List, Optional, Union

import numpy as np
import torch


def _stable_hash_u64(*parts: Any) -> int:
    """Stable 64-bit hash of arbitrary parts (blake2b; unlike ``hash`` it is
    the same in every process and run)."""
    h = hashlib.blake2b(digest_size=8)
    for part in parts:
        if isinstance(part, (bytes, bytearray)):
            h.update(bytes(part))
        elif isinstance(part, str):
            h.update(part.encode("utf-8"))
        elif isinstance(part, (int, np.integer)):
            h.update(int(part).to_bytes(16, "little", signed=True))
        elif isinstance(part, float):
            h.update(np.float64(part).tobytes())
        else:
            h.update(repr(part).encode("utf-8"))
        h.update(b"\x00")
    return int.from_bytes(h.digest(), "little")


def derive_seed(*parts: Any) -> int:
    """Deterministic 63-bit seed from arbitrary parts."""
    return _stable_hash_u64(*parts) & 0x7FFF_FFFF_FFFF_FFFF


def make_generator(device: Union[str, torch.device], *parts: Any) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``derive_seed(*parts)``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive_seed(*parts))
    return gen


def generators_for_prompts(prompts: Iterable[str], seed: int,
                           device: Union[str, torch.device]) -> List[torch.Generator]:
    """One generator per prompt, seeded from (prompt, seed): the port's
    counterpart of the JAX ``keys_for_prompts`` (``utils/base.py:82``). A
    prompt gets the same eval noise whatever batch it lands in."""
    return [make_generator(device, "prompt", p, seed) for p in prompts]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Asking for CUDA without a card raises — the port never quietly
    carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def use_full_fp32() -> None:
    """fp32 matmuls and convolutions computed in full fp32, as the JAX
    reference computes them: cuDNN would otherwise round an fp32
    convolution's inputs to TF32 (the VAE's fp32 output convolution). The
    entry points call it; it changes nothing on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
