"""Distributed K-repeat batch samplers (the port's copy of
``flow_factory_tpu/data/sampler.py``: the same draws for the same
(seed, epoch, rank)).

Re-implementation of the reference's three sampler contracts
(``src/flow_factory/data_utils/sampler.py:36-280``) as plain, seed-
deterministic index generators. They need no process group: every rank runs
the same epoch-seeded RNG, so cross-rank agreement holds by construction —
the property the reference relies on for communication-topology-aware reward
and advantage paths (SURVEY.md §2.3), and the property that makes them unit-
testable without devices.

Contracts (M unique prompts, K = group_size, W = num_replicas, B = batch):

* ``DistributedKRepeatSampler`` — global M×K pool shuffled, strided across
  ranks; group members scatter over ranks ⇒ advantages need a gather.
* ``GroupContiguousSampler``   — whole groups live on one rank, contiguous
  in the batch ⇒ zero-communication rewards/advantages (async-reward path).
* ``GroupDistributedSampler``  — every rank yields the SAME index sequence,
  K/W copies per rank; each global micro-batch is group-complete ⇒ DGPO's
  single-reduce contract.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


class BaseKRepeatSampler:
    """Epoch-seeded batch sampler yielding lists of dataset indices."""

    def __init__(
        self,
        dataset_size: int,
        unique_sample_num: int,
        group_size: int,
        batch_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 42,
    ):
        if dataset_size <= 0:
            raise ValueError("dataset_size must be positive")
        self.dataset_size = dataset_size
        self.unique_sample_num = unique_sample_num
        self.group_size = group_size
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self._validate()

    def _validate(self) -> None:
        total = self.unique_sample_num * self.group_size
        per_iter = self.num_replicas * self.batch_size
        if total % per_iter != 0:
            raise ValueError(
                f"M*K={total} must divide into whole iterations of W*B={per_iter}"
            )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch))

    def _draw_uniques(self, rng: np.random.Generator) -> np.ndarray:
        """M unique dataset indices; cycles the dataset when M > size."""
        m = self.unique_sample_num
        reps = -(-m // self.dataset_size)
        pool = np.concatenate([rng.permutation(self.dataset_size) for _ in range(reps)])
        return pool[:m]

    @property
    def num_batches(self) -> int:
        return (self.unique_sample_num * self.group_size) // (
            self.num_replicas * self.batch_size
        )

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[List[int]]:
        raise NotImplementedError


class DistributedKRepeatSampler(BaseKRepeatSampler):
    """Global shuffled M×K pool, strided per-rank slices."""

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng()
        uniques = self._draw_uniques(rng)
        pool = np.repeat(uniques, self.group_size)
        pool = pool[rng.permutation(len(pool))]
        local = pool[self.rank :: self.num_replicas]
        for b in range(self.num_batches):
            yield local[b * self.batch_size : (b + 1) * self.batch_size].tolist()


class GroupContiguousSampler(BaseKRepeatSampler):
    """Whole groups per rank, contiguous within the local sequence.

    Requires ``M % W == 0`` and ``(M/W)*K % B == 0`` — enforced by config
    geometry alignment. Groups are dealt round-robin to ranks then the local
    group order is shuffled rank-locally (deterministic in (seed, epoch, rank)).
    """

    def _validate(self) -> None:
        super()._validate()
        if self.unique_sample_num % self.num_replicas != 0:
            raise ValueError("group_contiguous requires M % W == 0")
        local_total = (self.unique_sample_num // self.num_replicas) * self.group_size
        if local_total % self.batch_size != 0:
            raise ValueError("group_contiguous requires (M/W)*K % B == 0")

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng()
        uniques = self._draw_uniques(rng)
        mine = uniques[self.rank :: self.num_replicas]
        local_rng = np.random.default_rng((self.seed, self.epoch, self.rank))
        mine = mine[local_rng.permutation(len(mine))]
        local = np.repeat(mine, self.group_size)
        n_local_batches = len(local) // self.batch_size
        for b in range(n_local_batches):
            yield local[b * self.batch_size : (b + 1) * self.batch_size].tolist()

    @property
    def num_batches(self) -> int:
        return (
            (self.unique_sample_num // self.num_replicas) * self.group_size
        ) // self.batch_size


class GroupDistributedSampler(BaseKRepeatSampler):
    """Identical sequence on every rank; K/W copies per rank (DGPO contract).

    Requires ``K % W == 0`` and ``(W*B) % K == 0`` (so every global
    micro-batch holds complete groups) — enforced by config alignment
    (``hparams/args.py`` ``_align_group_size_for_group_distributed``).
    """

    def _validate(self) -> None:
        super()._validate()
        if self.group_size % self.num_replicas != 0:
            raise ValueError("group_distributed requires K % W == 0")
        if (self.num_replicas * self.batch_size) % self.group_size != 0:
            raise ValueError("group_distributed requires (W*B) % K == 0")

    @property
    def copies_per_rank(self) -> int:
        return self.group_size // self.num_replicas

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng()
        uniques = self._draw_uniques(rng)
        d = self.copies_per_rank
        seq = np.repeat(uniques, d)  # SAME on every rank
        n_batches = len(seq) // self.batch_size
        for b in range(n_batches):
            yield seq[b * self.batch_size : (b + 1) * self.batch_size].tolist()

    @property
    def num_batches(self) -> int:
        return (self.unique_sample_num * self.copies_per_rank) // self.batch_size


_SAMPLER_REGISTRY = {
    "distributed_k_repeat": DistributedKRepeatSampler,
    "group_contiguous": GroupContiguousSampler,
    "group_distributed": GroupDistributedSampler,
}


def get_data_sampler(sampler_type: str, **kwargs) -> BaseKRepeatSampler:
    if sampler_type not in _SAMPLER_REGISTRY:
        raise KeyError(f"Unknown sampler_type {sampler_type!r}; have {sorted(_SAMPLER_REGISTRY)}")
    return _SAMPLER_REGISTRY[sampler_type](**kwargs)
