"""Selective trajectory storage for rollouts.

The reference collects latents/log-probs into Python lists during its eager
denoise loop (``src/flow_factory/utils/trajectory_collector.py:40-180``). On
the device the rollout writes into preallocated buffers, so selective storage
becomes a *data-driven scatter*: we pre-allocate a compact buffer with one extra
garbage slot and pass a ``(T+1,)`` int32 ``store_slot`` map into the rollout
loop. Positions that should not be stored map to the garbage slot, so every
step writes unconditionally and only the *number* of stored positions
(fixed by config) shapes the buffers.

Position convention (same as reference): a T-step rollout has T+1 latent
positions (initial noise + each step result) and T log-prob positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np


def compute_trajectory_indices(
    train_timestep_indices: Union[Sequence[int], np.ndarray],
    num_inference_steps: int,
    include_initial: bool = False,
) -> List[int]:
    """Minimal set of latent positions needed for training.

    For each training step index ``i`` the trainer needs positions ``i``
    (current latents) and ``i+1`` (next latents); returns the deduplicated
    sorted union. Mirrors reference ``utils/trajectory_collector.py:344-388``.
    """
    indices = np.asarray(train_timestep_indices).reshape(-1).tolist()
    total_positions = num_inference_steps + 1
    positions = set()
    if include_initial:
        positions.add(0)
    for idx in indices:
        idx = int(idx)
        if 0 <= idx < total_positions:
            positions.add(idx)
        if 0 <= idx + 1 < total_positions:
            positions.add(idx + 1)
    return sorted(positions)


@dataclass(frozen=True)
class TrajectoryIndexMaps:
    """Index bookkeeping for compact trajectory buffers.

    Attributes:
        num_latent_slots: compact latent buffer size (excluding garbage slot).
        num_logprob_slots: compact log-prob buffer size (excluding garbage slot).
        latent_store_slot: (T+1,) int32 — position → compact slot, garbage slot
            (= num_latent_slots) when not stored. Feed into the rollout loop.
        logprob_store_slot: (T,) int32 — step → compact slot / garbage slot.
        latent_index_map: (T+1,) int32 — position → compact index or -1
            (host-side lookup used by trainers; mirrors reference index maps).
        logprob_index_map: (T,) int32 — step → compact index or -1.
    """

    num_latent_slots: int
    num_logprob_slots: int
    latent_store_slot: np.ndarray
    logprob_store_slot: np.ndarray
    latent_index_map: np.ndarray
    logprob_index_map: np.ndarray


def build_store_maps(
    trajectory_indices: Optional[Union[str, Sequence[int]]],
    num_inference_steps: int,
) -> TrajectoryIndexMaps:
    """Build scatter maps for rollout-side selective storage.

    ``trajectory_indices`` follows the reference convention:
    ``'all'`` stores every position, ``None`` stores nothing (buffers sized 0),
    a list stores exactly those latent positions (negative indices allowed).
    Log-probs are stored at every stored position ``< T`` (a superset of the
    train steps, as in the reference collectors).
    """
    T = num_inference_steps
    total_positions = T + 1

    if trajectory_indices is None:
        positions: List[int] = []
    elif isinstance(trajectory_indices, str):
        if trajectory_indices != "all":
            raise ValueError(f"Unknown trajectory_indices: {trajectory_indices!r}")
        positions = list(range(total_positions))
    else:
        norm = set()
        for idx in trajectory_indices:
            idx = int(idx)
            if idx < 0:
                idx = total_positions + idx
            if 0 <= idx < total_positions:
                norm.add(idx)
        positions = sorted(norm)

    logprob_positions = [p for p in positions if p < T]

    num_latent_slots = len(positions)
    num_logprob_slots = len(logprob_positions)

    latent_store_slot = np.full((total_positions,), num_latent_slots, dtype=np.int32)
    latent_index_map = np.full((total_positions,), -1, dtype=np.int32)
    for compact, pos in enumerate(positions):
        latent_store_slot[pos] = compact
        latent_index_map[pos] = compact

    logprob_store_slot = np.full((max(T, 1),), num_logprob_slots, dtype=np.int32)[:T]
    logprob_index_map = np.full((max(T, 1),), -1, dtype=np.int32)[:T]
    for compact, pos in enumerate(logprob_positions):
        logprob_store_slot[pos] = compact
        logprob_index_map[pos] = compact

    return TrajectoryIndexMaps(
        num_latent_slots=num_latent_slots,
        num_logprob_slots=num_logprob_slots,
        latent_store_slot=latent_store_slot,
        logprob_store_slot=logprob_store_slot,
        latent_index_map=latent_index_map,
        logprob_index_map=logprob_index_map,
    )
