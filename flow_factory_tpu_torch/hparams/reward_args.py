"""Reward configuration group (reference schema: ``hparams/reward_args.py``).

Each entry configures one reward model; the list forms a
``MultiRewardArguments``. The identity key dedups reward models that are
configured identically for train and eval (reference
``reward_args.get_identity_key``, ``hparams/reward_args.py:139-152``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .abc import ArgABC


@dataclass(kw_only=True)
class RewardArguments(ArgABC):
    name: str = field(default="reward")
    reward_model: str = field(default="MyReward")
    weight: float = field(default=1.0)
    batch_size: int = field(default=16)
    device: str = field(default="cpu")  # host-side reward workers
    dtype: str = field(default="float32")
    model_name_or_path: Optional[str] = field(default=None)
    async_reward: bool = field(default=False)
    num_workers: int = field(default=1)
    # Remote / server rewards
    server_url: Optional[str] = field(default=None)
    timeout: float = field(default=60.0)
    retry_attempts: int = field(default=3)

    def get_identity_key(self) -> tuple:
        """Key identifying an instantiable reward model (for dedup between
        train and eval reward sets)."""
        return (
            self.reward_model,
            self.model_name_or_path,
            self.device,
            self.dtype,
            self.server_url,
            tuple(sorted((self.extra_kwargs or {}).items())),
        )


class MultiRewardArguments(list):
    """A list of RewardArguments with convenience constructors."""

    @classmethod
    def from_list(cls, entries: Optional[List[Dict[str, Any]]]) -> "MultiRewardArguments":
        return cls(RewardArguments.from_dict(e) for e in (entries or []))

    @property
    def reward_weights(self) -> Dict[str, float]:
        return {r.name: r.weight for r in self}

    def to_list(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self]
