"""Dataloader orchestration (port of ``flow_factory_tpu/data/loader.py``).

Resolve the dataset splits (``train``/``test`` files under ``dataset_dir``),
run the cached preprocessing with the adapter's ``preprocess_func``, and wrap
the result in sampler-driven loaders. Batches are plain dicts of stacked host
numpy arrays; the trainer moves what it needs to the device. The world size
and rank come from the port's ``parallel/dist.py``: one data-parallel replica
per process, the ranks of one ``tensor`` group sharing theirs.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..parallel.dist import get_data_rank, get_world_size
from .dataset import GeneralDataset, PreprocessedDataset
from .sampler import BaseKRepeatSampler, get_data_sampler


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Ragged-aware collation: uniform arrays stack, everything else stays a list."""
    if not items:
        return {}
    out: Dict[str, Any] = {}
    for k in items[0]:
        values = [it.get(k) for it in items]
        first = values[0]
        if isinstance(first, np.ndarray) and all(
                isinstance(v, np.ndarray) and v.shape == first.shape and v.dtype == first.dtype
                for v in values):
            out[k] = np.stack(values)
        else:
            out[k] = values
    return out


def _fetch(dataset, idxs: List[int]) -> Dict[str, Any]:
    if hasattr(dataset, "get_batch"):
        return dataset.get_batch(idxs)
    return collate([dataset[i] for i in idxs])


class MultiReplicaLoader:
    """Per-process loader over the local replicas' samplers: every iteration
    concatenates their index batches, ordered by replica, into one batch."""

    def __init__(self, dataset: PreprocessedDataset, samplers: List[BaseKRepeatSampler]):
        if not samplers:
            raise ValueError("need at least one replica sampler")
        self.dataset = dataset
        self.samplers = samplers

    def set_epoch(self, epoch: int) -> None:
        for s in self.samplers:
            s.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.samplers[0])

    @property
    def batch_size(self) -> int:
        return sum(s.batch_size for s in self.samplers)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for idx_batches in zip(*self.samplers):
            idxs = [i for b in idx_batches for i in b]
            batch = _fetch(self.dataset, idxs)
            batch["_indices"] = idxs
            yield batch


class SequentialLoader:
    """Plain strided loader for evaluation (process-sharded, no K-repeat);
    tail batches repeat their last row up to a multiple of ``pad_to``, the
    pad count in ``_num_pad``. Every rank yields as many batches, each as
    large as the widest rank's (a rank short of rows pads): the rollouts
    run the same collectives on every rank."""

    def __init__(self, dataset: PreprocessedDataset, batch_size: int, rank: int = 0,
                 world: int = 1, pad_to: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to = max(1, pad_to)
        self.indices = list(range(rank, len(dataset), world))
        self.rows = -(-len(dataset) // world)  # the widest rank's

    def __len__(self) -> int:
        return -(-self.rows // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for b in range(len(self)):
            lo = b * self.batch_size
            idxs = self.indices[lo : lo + self.batch_size]
            width = min(self.batch_size, self.rows - lo)
            pad = width - len(idxs) + (-width) % self.pad_to
            idxs = idxs + [idxs[-1] if idxs else self.indices[-1] if self.indices else 0] * pad
            batch = _fetch(self.dataset, idxs)
            batch["_indices"] = idxs
            batch["_num_pad"] = pad
            yield batch


def _resolve_split_path(dataset_dir: str, split: str) -> Optional[str]:
    if os.path.isfile(dataset_dir):
        return dataset_dir if split == "train" else None
    for ext in ("txt", "jsonl", "json"):
        p = os.path.join(dataset_dir, f"{split}.{ext}")
        if os.path.exists(p):
            return p
    return None


def get_dataloader(
    config,
    preprocess_func: Optional[Callable] = None,
    preprocess_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[MultiReplicaLoader, Optional[SequentialLoader]]:
    """The (train, test) loaders of the config's geometry."""
    da, ta = config.data_args, config.training_args
    cache_dir = os.path.expanduser(da.cache_dir)
    # the data-parallel replicas: the ranks of one tensor group read the same rows
    world, rank = get_world_size(), get_data_rank()
    model_id = config.model_args.model_name_or_path or config.model_args.model_type
    variant = getattr(config.model_args, "variant", None)
    if variant:  # a preset of one path (``tiny``, ``ltx2``) encodes prompts its own way
        model_id = f"{model_id}@{variant}"

    train_path = _resolve_split_path(da.dataset_dir, "train")
    if train_path is None:
        raise FileNotFoundError(f"No train split found under {da.dataset_dir}")
    train_ds = GeneralDataset(train_path, "train", cutoff=da.max_dataset_size).preprocess(
        preprocess_func, cache_dir, func_kwargs=preprocess_kwargs, model_id=model_id,
        batch_size=da.preprocessing_batch_size)
    # one replica a process: its sampler
    samplers = [get_data_sampler(
        da.sampler_type,
        dataset_size=len(train_ds),
        unique_sample_num=ta.unique_sample_num_per_epoch,
        group_size=ta.group_size,
        batch_size=ta.per_device_batch_size,
        num_replicas=world,
        rank=rank,
        seed=ta.seed,
    )]
    train_loader = MultiReplicaLoader(train_ds, samplers)

    test_loader = None
    test_path = _resolve_split_path(da.dataset_dir, "test")
    if test_path is not None:
        test_ds = GeneralDataset(test_path, "test", cutoff=getattr(config.eval_args, "max_size", None)).preprocess(
            preprocess_func, cache_dir, func_kwargs=preprocess_kwargs, model_id=model_id,
            batch_size=da.preprocessing_batch_size)
        eval_bs = getattr(config.eval_args, "per_device_batch_size", None) or ta.per_device_batch_size
        test_loader = SequentialLoader(test_ds, eval_bs, rank=rank, world=world)
    return train_loader, test_loader
