"""Rollout sample containers.

The PyTorch port's copy of ``flow_factory_tpu/samples/samples.py`` (kept
apart so the port never imports the JAX package). Key properties:

* Samples live on the **host** as numpy arrays (the reference's
  ``offload_samples_to_cpu`` path — device memory only ever holds the current
  minibatch; rollout outputs are copied to host numpy once per rollout).
* ``stack_samples()`` produces a dict of numpy arrays that the replay moves to
  the device; per-sample striping happens only at the reward/host boundary.
* Trajectory storage is compact: ``all_latents`` holds only the positions a
  trainer asked for, addressed through dense host-side index maps
  (reference ``TrajectoryCollector`` / ``latent_index_map`` semantics).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, fields
from typing import Any, ClassVar, Dict, List, Optional, Sequence

import numpy as np

from ..utils.media import hash_array, hash_media, to_audio_array, to_image_array, to_video_array

__all__ = [
    "BaseSample",
    "ImageConditionSample",
    "VideoConditionSample",
    "T2ISample",
    "T2VSample",
    "T2AVSample",
    "I2ISample",
    "I2VSample",
    "I2AVSample",
    "V2VSample",
    "stack_samples",
]


@dataclass
class BaseSample:
    """One rollout, batch-dim stripped, host-resident.

    Mirrors the reference field contract (``samples/samples.py:84-108``) so
    trainers/rewards written against the reference translate directly.
    """

    _id_fields: ClassVar[frozenset] = frozenset(
        {"prompt", "prompt_ids", "negative_prompt", "negative_prompt_ids"}
    )
    _shared_fields: ClassVar[frozenset] = frozenset(
        {"height", "width", "latent_index_map", "log_prob_index_map"}
    )

    # Denoising trajectory (numpy, compact storage)
    timesteps: Optional[np.ndarray] = None  # (T,) f32 scheduler-scale
    all_latents: Optional[np.ndarray] = None  # (num_stored, *latent_shape)
    latent_index_map: Optional[np.ndarray] = None  # (T+1,) int64, -1 = not stored
    log_probs: Optional[np.ndarray] = None  # (num_stored_lp,) f32
    log_prob_index_map: Optional[np.ndarray] = None  # (T,) int64, -1 = not stored
    # Output dims
    height: Optional[int] = None
    width: Optional[int] = None
    # Generated media (canonical: image (C,H,W), video (T,C,H,W), audio (C,T))
    image: Optional[np.ndarray] = None
    video: Optional[np.ndarray] = None
    audio: Optional[np.ndarray] = None
    audio_sample_rate: Optional[int] = None
    # Prompt info
    prompt: Optional[str] = None
    prompt_ids: Optional[np.ndarray] = None
    prompt_embeds: Optional[np.ndarray] = None
    negative_prompt: Optional[str] = None
    negative_prompt_ids: Optional[np.ndarray] = None
    negative_prompt_embeds: Optional[np.ndarray] = None
    extra_kwargs: Dict[str, Any] = field(default_factory=dict)

    _unique_id: Optional[str] = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.image is not None:
            self.image = to_image_array(self.image)
        if self.video is not None:
            self.video = to_video_array(self.video)
        if self.audio is not None:
            self.audio = to_audio_array(self.audio)

    # -- attribute fallback into extra_kwargs (reference :193-210) ----------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        extra = self.__dict__.get("extra_kwargs")
        if extra is not None and name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    # -- identity ------------------------------------------------------------
    @property
    def unique_id(self) -> str:
        """Content hash of prompt + condition media: group key for advantages.

        Reference: sha256 over ``_id_fields`` (``samples/samples.py:252-292``).
        """
        if self._unique_id is None:
            h = hashlib.sha256()
            for name in sorted(type(self)._id_fields):
                value = getattr(self, name, None)
                if value is None:
                    continue
                if isinstance(value, np.ndarray):
                    h.update(hash_array(value).encode())
                elif isinstance(value, (list, tuple)):
                    h.update(hash_media(value).encode())
                else:
                    h.update(str(value).encode())
            # condition identity carried only as preprocessed latents/tokens
            # (trainer rollouts forward cond_latents, not raw media): two
            # same-prompt records with different conditions must NOT share a
            # group (reference hashes condition media into the id)
            for ck in ("cond_latents", "cond_tokens", "image_embeds",
                       "condition_video_latents"):
                cv = self.extra_kwargs.get(ck)
                if cv is not None and isinstance(cv, np.ndarray):
                    h.update(hash_array(cv).encode())
            object.__setattr__(self, "_unique_id", h.hexdigest())
        return self._unique_id

    # -- conversion ------------------------------------------------------------
    def asdict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self) if not f.name.startswith("_")}


@dataclass
class ImageConditionSample(BaseSample):
    """Sample conditioned on one or more input images (I2I/I2V/I2AV).

    ``images`` canonicalizes to a list of (C,H,W) arrays (reference
    ``samples/samples.py:378-404`` unbind-to-list).
    """

    _id_fields: ClassVar[frozenset] = BaseSample._id_fields | {"images"}

    images: Optional[List[np.ndarray]] = None

    @property
    def condition_images(self) -> Optional[List[np.ndarray]]:
        """Reference field-name alias (``required_fields`` of ported reward
        models use ``condition_images``; reference rewards/abc.py:150)."""
        return self.images
    image_latents: Optional[np.ndarray] = None

    def __post_init__(self):
        super().__post_init__()
        if self.images is not None:
            if isinstance(self.images, np.ndarray) and self.images.ndim == 4:
                self.images = [to_image_array(i) for i in self.images]
            elif not isinstance(self.images, list):
                self.images = [to_image_array(self.images)]
            else:
                self.images = [to_image_array(i) for i in self.images]


@dataclass
class VideoConditionSample(BaseSample):
    """Sample conditioned on an input video (V2V)."""

    _id_fields: ClassVar[frozenset] = BaseSample._id_fields | {"condition_video"}

    condition_video: Optional[np.ndarray] = None
    condition_video_latents: Optional[np.ndarray] = None

    @property
    def condition_videos(self) -> Optional[List[np.ndarray]]:
        """Reference field-name alias (reference rewards/abc.py:151)."""
        return None if self.condition_video is None else [self.condition_video]

    def __post_init__(self):
        super().__post_init__()
        if self.condition_video is not None:
            self.condition_video = to_video_array(self.condition_video)


# Task aliases (reference ``samples/samples.py:433-466``)
T2ISample = BaseSample
T2VSample = BaseSample
T2AVSample = BaseSample
I2ISample = ImageConditionSample
I2VSample = ImageConditionSample
I2AVSample = ImageConditionSample
V2VSample = VideoConditionSample


def stack_samples(
    samples: Sequence[BaseSample],
    field_names: Optional[Sequence[str]] = None,
    extra_keys: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Stack per-sample arrays into batched numpy arrays.

    Shared fields (height/width/index maps) are taken from the first sample;
    array fields gain a leading batch dim; strings become lists. Equivalent of
    reference ``BaseSample.stack`` (``samples/samples.py:294-375``) returning a
    plain dict (the caller moves it to the device).
    """
    if not samples:
        return {}
    first = samples[0]
    out: Dict[str, Any] = {}
    names = field_names or [f.name for f in fields(first) if not f.name.startswith("_")]
    for name in names:
        if name == "extra_kwargs":
            continue
        value = getattr(first, name, None)
        if name in type(first)._shared_fields:
            out[name] = value
            continue
        if value is None:
            continue
        values = [getattr(s, name) for s in samples]
        if isinstance(value, np.ndarray):
            out[name] = np.stack(values, axis=0)
        elif isinstance(value, list) and value and isinstance(value[0], np.ndarray):
            # ragged condition lists: keep list-of-lists
            out[name] = values
        else:
            out[name] = values
    keys = set(extra_keys or [])
    if not keys:
        for s in samples:
            keys |= set(s.extra_kwargs)
    for key in keys:
        values = [s.extra_kwargs.get(key) for s in samples]
        if all(isinstance(v, np.ndarray) for v in values):
            out[key] = np.stack(values, axis=0)
        elif all(isinstance(v, (int, float, np.floating, np.integer)) for v in values):
            out[key] = np.asarray(values)
        else:
            out[key] = values
    return out
