"""Media canonicalization: images, videos, audio.

The PyTorch port's copy of the parts of ``flow_factory_tpu/utils/media.py``
that the samples need: the reference's media type lattice
(``src/flow_factory/utils/image.py``, ``video.py``, ``audio.py``). Media only
ever lives on the *host* here (rollout outputs are fetched to host numpy before
reward scoring / logging), so everything is numpy + PIL, with no framework
tensors in the signatures.

Canonical forms (float32 in [0, 1] unless stated):
  image  (C, H, W)        single  |  (B, C, H, W)        batch
  video  (T, C, H, W)     single  |  (B, T, C, H, W)     batch
  audio  (C, T) waveform float32 in [-1, 1]
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional

import numpy as np

try:  # optional: only PIL inputs need it
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None  # type: ignore


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

def is_pil_image(x: Any) -> bool:
    return Image is not None and isinstance(x, Image.Image)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def _chw_from_any(img: Any) -> np.ndarray:
    """Single image of any layout → float32 (C, H, W) in [0, 1]."""
    if is_pil_image(img):
        arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return np.transpose(arr, (2, 0, 1))
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"Expected a single image; got shape {arr.shape}")
    # channel-last heuristic: last dim in {1,3,4} and first dim not
    if arr.shape[-1] in (1, 3, 4) and arr.shape[0] not in (1, 3, 4):
        arr = np.transpose(arr, (2, 0, 1))
    arr = arr.astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    return arr


def to_image_array(img: Any) -> np.ndarray:
    """Canonical single image (C, H, W) float32 [0, 1]."""
    return _chw_from_any(img)


def to_video_array(video: Any) -> np.ndarray:
    """Canonical single video (T, C, H, W) float32 [0, 1]."""
    if isinstance(video, np.ndarray) and video.ndim == 4:
        # Could be (T,H,W,C) or (T,C,H,W)
        if video.shape[-1] in (1, 3, 4) and video.shape[1] not in (1, 3, 4):
            video = np.transpose(video, (0, 3, 1, 2))
        video = video.astype(np.float32)
        if video.max() > 1.5:
            video = video / 255.0
        return video
    if isinstance(video, (list, tuple)):
        return np.stack([_chw_from_any(f) for f in video], axis=0)
    raise ValueError(f"Cannot canonicalize video of type {type(video)}")


def to_audio_array(audio: Any) -> np.ndarray:
    """Canonical waveform (C, T) float32 in [-1, 1]."""
    arr = np.asarray(audio, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"Expected waveform (C,T) or (T,); got shape {arr.shape}")
    return arr


# ---------------------------------------------------------------------------
# Hashing (sample identity)
# ---------------------------------------------------------------------------

def hash_array(arr: Optional[np.ndarray]) -> str:
    if arr is None:
        return "none"
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def hash_media(x: Any) -> str:
    """Stable content hash for any canonicalizable media object."""
    if x is None:
        return "none"
    if is_pil_image(x):
        return hash_array(np.asarray(x))
    if isinstance(x, (list, tuple)):
        h = hashlib.sha256()
        for item in x:
            h.update(hash_media(item).encode())
        return h.hexdigest()
    if isinstance(x, np.ndarray):
        return hash_array(x)
    return hashlib.sha256(repr(x).encode()).hexdigest()
