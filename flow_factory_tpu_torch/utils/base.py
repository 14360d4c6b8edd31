"""Core glue utilities (port of ``flow_factory_tpu/utils/base.py``).

Deterministic seeds come from stable hashes of arbitrary parts; the port turns
them into explicit ``torch.Generator`` objects instead of JAX keys. Devices
are explicit: entry points default to ``cuda`` and never fall back to the CPU.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional, Union

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
