"""Built-in reward models of the port (from ``flow_factory_tpu/rewards/models.py``).

``MyReward`` returns a deterministic, optimisable signal (mean image
brightness) so smoke runs have a real direction to follow; ``MyGroupReward``
ranks it within a group. The native CLIP-H scorer is
:mod:`.clip_native`; the rewards that need local weights of another package
or a server are not ported (:mod:`.registry`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .abc import GroupwiseRewardModel, PointwiseRewardModel


class MyReward(PointwiseRewardModel):
    """Pointwise reward: mean brightness in [0, 1]; videos score as the frame mean."""

    required_fields = ("image", "video", "prompt")

    def compute_reward(self, image: Sequence[np.ndarray], prompt: Sequence[str],
                       video: Optional[Sequence[np.ndarray]] = None, **_) -> np.ndarray:
        out = []
        for i in range(len(prompt)):
            img = image[i] if image is not None else None
            vid = video[i] if video is not None else None
            media = img if img is not None else vid
            out.append(float(np.mean(media)) if media is not None else 0.0)
        return np.asarray(out, np.float64)


class MyGroupReward(GroupwiseRewardModel):
    """Groupwise reward: the brightness rank within the group, in [0, 1]."""

    required_fields = ("image", "prompt")

    def compute_group_reward(self, image: Sequence[np.ndarray], prompt: Sequence[str], **_) -> np.ndarray:
        vals = np.asarray([float(np.mean(img)) if img is not None else 0.0 for img in image])
        order = np.argsort(np.argsort(vals))
        if len(vals) <= 1:
            return np.ones_like(vals)
        return order.astype(np.float64) / (len(vals) - 1)
