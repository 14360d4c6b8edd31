"""Multi-reward instantiation with identity-key dedup (port of
``flow_factory_tpu/rewards/loader.py``): reward models configured identically
for train and eval share one instance; each entry keeps its own name and
weight."""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..hparams.reward_args import MultiRewardArguments, RewardArguments
from .abc import BaseRewardModel
from .registry import resolve_reward_class

logger = logging.getLogger(__name__)


class MultiRewardLoader:
    def __init__(self):
        self._instances: Dict[tuple, BaseRewardModel] = {}

    def load(self, reward_args: Optional[MultiRewardArguments]) -> List[BaseRewardModel]:
        models: List[BaseRewardModel] = []
        for entry in reward_args or []:
            key = entry.get_identity_key()
            if key in self._instances:
                base = self._instances[key]
                same = base.name == entry.name and base.weight == entry.weight
                models.append(base if same else _RewardAlias(base, entry))
                continue
            model = resolve_reward_class(entry.reward_model)(entry)
            self._instances[key] = model
            models.append(model)
            logger.info("Loaded reward model %s (%s)", entry.name, entry.reward_model)
        return models


class _RewardAlias(BaseRewardModel):
    """Same scorer instance under a different (name, weight)."""

    def __init__(self, base: BaseRewardModel, args: RewardArguments):
        super().__init__(args)
        self._base = base
        self.required_fields = base.required_fields
        self.reward_type = base.reward_type
        self.media_format = base.media_format

    def setup(self) -> None:
        self._base.setup()

    def cleanup(self) -> None:
        pass  # the owner cleans up

    def __getattr__(self, name):
        return getattr(self._base, name)
