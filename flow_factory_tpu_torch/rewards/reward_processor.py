"""Reward scoring, pointwise path (from ``flow_factory_tpu/rewards/reward_processor.py``).

Samples handed to rewards are host-resident numpy (the rollout copies its
results to the host once), so scoring is plain batched host code. Groupwise
and asynchronous scoring come with a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..samples import BaseSample
from .abc import BaseRewardModel, PointwiseRewardModel


class RewardProcessor:
    """Synchronous scoring of a list of reward models over samples."""

    def __init__(self, reward_models: Sequence[BaseRewardModel],
                 reward_weights: Optional[Dict[str, float]] = None):
        self.reward_models = list(reward_models)
        self.reward_weights = reward_weights or {}
        self._setup_done = False

    def _ensure_setup(self) -> None:
        if not self._setup_done:
            for m in self.reward_models:
                m.setup()
            self._setup_done = True

    def _score_pointwise(self, model: PointwiseRewardModel, samples: List[BaseSample]) -> np.ndarray:
        self._ensure_setup()
        scores = np.zeros(len(samples), np.float64)
        for start in range(0, len(samples), model.batch_size):
            chunk = samples[start : start + model.batch_size]
            fields = model.extract_fields(chunk)
            out = np.asarray(model.compute_reward(**fields), np.float64).reshape(-1)
            scores[start : start + len(chunk)] = out
        return scores

    def score(self, samples: List[BaseSample]) -> Dict[str, np.ndarray]:
        results: Dict[str, np.ndarray] = {}
        for model in self.reward_models:
            if not isinstance(model, PointwiseRewardModel):
                raise NotImplementedError(
                    f"reward {model.name!r} is {model.reward_type}: only pointwise rewards are ported")
            results[model.name] = self._score_pointwise(model, samples)
        return results

    def score_and_attach(self, samples: List[BaseSample]) -> Dict[str, np.ndarray]:
        """Score, then attach ``extra_kwargs['rewards']`` (per model) and the
        weighted ``extra_kwargs['reward']`` as the trainer's reward buffer does."""
        per_model = self.score(samples)
        for i, s in enumerate(samples):
            rewards = {name: float(scores[i]) for name, scores in per_model.items()}
            s.extra_kwargs["rewards"] = rewards
            s.extra_kwargs["reward"] = sum(self.reward_weights.get(k, 1.0) * v for k, v in rewards.items())
        return per_model
