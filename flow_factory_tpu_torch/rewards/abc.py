"""Reward model interfaces.

Re-design of the reference reward ABCs
(``src/flow_factory/rewards/abc.py:43-186``). Rewards are HOST-side scorers
(numpy in, floats out) — the rollout result is already copied to the host
before scoring, so there is no device-stream choreography; asynchrony is pure
thread-pool overlap with the next rollout batch (see ``reward_processor``).

Two shapes:
* Pointwise — independent scalar per sample.
* Groupwise — scores computed over a complete prompt-group (same unique_id),
  e.g. intra-group ranking; requires group-complete inputs which the
  processor guarantees per sampler contract.
"""
from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..samples import BaseSample

logger = logging.getLogger(__name__)


class BaseRewardModel(ABC):
    """One reward scorer. ``required_fields`` are pulled off samples."""

    #: sample fields this model consumes, e.g. ('image', 'prompt')
    required_fields: Tuple[str, ...] = ("image", "prompt")
    #: 'pointwise' or 'groupwise'
    reward_type: str = "pointwise"
    #: media format handed to compute_reward: 'np' (arrays) or 'pil'
    media_format: str = "np"

    def __init__(self, reward_args):
        self.args = reward_args
        self.name = reward_args.name
        self.weight = reward_args.weight
        self.batch_size = reward_args.batch_size

    def setup(self) -> None:
        """Lazy heavy init (model loads) — called once before first scoring."""

    def cleanup(self) -> None:
        """Release resources."""

    # -- field extraction ----------------------------------------------------
    def extract_fields(self, samples: Sequence[BaseSample]) -> Dict[str, List[Any]]:
        fields: Dict[str, List[Any]] = {}
        for f in self.required_fields:
            fields[f] = [getattr(s, f, None) for s in samples]
        return fields


class PointwiseRewardModel(BaseRewardModel):
    reward_type = "pointwise"

    @abstractmethod
    def compute_reward(self, **fields) -> np.ndarray:
        """Batched fields → (B,) float scores."""


class GroupwiseRewardModel(BaseRewardModel):
    reward_type = "groupwise"

    @abstractmethod
    def compute_group_reward(self, **fields) -> np.ndarray:
        """Fields of ONE complete group (K samples, same prompt) → (K,) scores."""


class GlobalwiseRewardModel(BaseRewardModel):
    """Rewards over ALL samples globally — a placeholder for future
    extension, mirroring the reference's API surface
    (``reference rewards/abc.py:182``; upstream is likewise a stub and
    notes it may merge with the advantage-computation stage)."""

    reward_type = "globalwise"
