"""Group-relative advantage computation.

Re-design of the reference ``AdvantageProcessor``
(``src/flow_factory/advantage/advantage_processor.py:106-635``). Advantages
are cheap host math over per-sample scalars, so everything runs in fp64
numpy; the only communication is one host allgather of (uid, reward-vector)
tuples when group members are scattered across processes
(distributed_k_repeat sampler) — the host analog of the reference's packed
(B, N+1) ``accelerator.gather`` trick.

Two aggregations (reference ``compute_advantages`` dispatch):
* 'sum'  — weighted-sum reward → per-group mean-center → std-normalize
           (global batch std or per-group std).
* 'gdpo' — per-reward per-group normalization → weighted sum → global
           batch re-normalization (GDPO, reference :403-481).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.dist import get_data_rank, get_world_size, host_allgather_objects
from ..samples import BaseSample

logger = logging.getLogger(__name__)

_EPS = 1e-8


class AdvantageProcessor:
    def __init__(
        self,
        group_size: int,
        aggregation: str = "sum",
        std_mode: str = "global",  # 'global' | 'per_group'
        reward_weights: Optional[Dict[str, float]] = None,
        distributed_groups: bool = False,
    ):
        if aggregation not in ("sum", "gdpo") and not callable(aggregation):
            raise ValueError(f"Unknown advantage aggregation {aggregation!r}")
        self.group_size = group_size
        self.aggregation = aggregation
        self.std_mode = std_mode
        self.reward_weights = reward_weights or {}
        self.distributed_groups = distributed_groups

    # ------------------------------------------------------------------
    # Collection
    # ------------------------------------------------------------------
    def _collect(
        self, samples: Sequence[BaseSample]
    ) -> Tuple[List[str], Dict[str, np.ndarray], np.ndarray, int]:
        """Returns (uids_global, per-reward matrix dict, local_slice_ids, offset).

        With distributed groups, gathers (uid, rewards-dict) rows from every
        process; local rows occupy a contiguous block at ``offset``.
        """
        local_rows = [
            (s.unique_id, dict(s.extra_kwargs.get("rewards", {"reward": s.extra_kwargs.get("reward", 0.0)})))
            for s in samples
        ]
        if self.distributed_groups and get_world_size() > 1:
            all_rows = host_allgather_objects(local_rows)
            offset = sum(len(r) for r in all_rows[: get_data_rank()])
            rows = [r for rank_rows in all_rows for r in rank_rows]
        else:
            rows, offset = local_rows, 0
        uids = [r[0] for r in rows]
        names = sorted({k for _, d in rows for k in d})
        mat = {name: np.asarray([d.get(name, 0.0) for _, d in rows], np.float64) for name in names}
        local_ids = np.arange(offset, offset + len(samples))
        return uids, mat, local_ids, offset

    @staticmethod
    def _groups(uids: List[str]) -> Dict[str, np.ndarray]:
        groups: Dict[str, List[int]] = {}
        for i, u in enumerate(uids):
            groups.setdefault(u, []).append(i)
        return {u: np.asarray(ix) for u, ix in groups.items()}

    # ------------------------------------------------------------------
    # Aggregations
    # ------------------------------------------------------------------
    def _weighted_total(self, mat: Dict[str, np.ndarray]) -> np.ndarray:
        total = None
        for name, vals in mat.items():
            w = self.reward_weights.get(name, 1.0)
            total = w * vals if total is None else total + w * vals
        return total if total is not None else np.zeros(0)

    def _compute_sum(self, uids: List[str], mat: Dict[str, np.ndarray]) -> np.ndarray:
        rewards = self._weighted_total(mat)
        groups = self._groups(uids)
        centered = np.zeros_like(rewards)
        for u, idx in groups.items():
            centered[idx] = rewards[idx] - rewards[idx].mean()
        if self.std_mode == "per_group":
            adv = np.zeros_like(centered)
            for u, idx in groups.items():
                adv[idx] = centered[idx] / (rewards[idx].std() + _EPS)
        else:
            adv = centered / (rewards.std() + _EPS)
        return adv

    def _compute_gdpo(self, uids: List[str], mat: Dict[str, np.ndarray]) -> np.ndarray:
        groups = self._groups(uids)
        combined = np.zeros(len(uids), np.float64)
        for name, vals in mat.items():
            w = self.reward_weights.get(name, 1.0)
            normed = np.zeros_like(vals)
            for u, idx in groups.items():
                normed[idx] = (vals[idx] - vals[idx].mean()) / (vals[idx].std() + _EPS)
            combined += w * normed
        return (combined - combined.mean()) / (combined.std() + _EPS)

    # ------------------------------------------------------------------
    # Public
    # ------------------------------------------------------------------
    def compute_advantages(self, samples: List[BaseSample]) -> Dict[str, float]:
        """Attach ``extra_kwargs['advantage']``; return metric payload
        (reference payload builders, ``advantage_processor.py:487-635``)."""
        if not samples:
            return {}
        uids, mat, local_ids, _ = self._collect(samples)
        if callable(self.aggregation):
            adv = np.asarray(self.aggregation(uids, mat), np.float64)
        elif self.aggregation == "gdpo":
            adv = self._compute_gdpo(uids, mat)
        else:
            adv = self._compute_sum(uids, mat)

        for i, s in zip(local_ids, samples):
            s.extra_kwargs["advantage"] = float(adv[i])

        rewards = self._weighted_total(mat)
        groups = self._groups(uids)
        group_stds = np.asarray([rewards[idx].std() for idx in groups.values()])
        group_means = np.asarray([rewards[idx].mean() for idx in groups.values()])
        metrics = {
            "reward/mean": float(rewards.mean()),
            "reward/std": float(rewards.std()),
            "reward/min": float(rewards.min()),
            "reward/max": float(rewards.max()),
            "advantage/mean": float(adv.mean()),
            "advantage/std": float(adv.std()),
            "advantage/abs_mean": float(np.abs(adv).mean()),
            "advantage/min": float(adv.min()),
            "advantage/max": float(adv.max()),
            # reward-collapse detector + group distribution payload
            # (reference ``_build_weighted_sum_log_data``,
            # advantage_processor.py:487-568: zero-std ratio, group-std
            # mean/max/min, spread of group means)
            "reward/zero_std_group_ratio": float((group_stds < _EPS).mean()),
            "reward/group_std_mean": float(group_stds.mean()),
            "reward/group_std_max": float(group_stds.max()),
            "reward/group_std_min": float(group_stds.min()),
            "reward/group_mean_std": float(group_means.std()),
        }
        for name, vals in mat.items():
            g_stds = np.asarray([vals[idx].std() for idx in groups.values()])
            g_means = np.asarray([vals[idx].mean() for idx in groups.values()])
            metrics[f"reward/{name}/mean"] = float(vals.mean())
            metrics[f"reward/{name}/std"] = float(vals.std())
            metrics[f"reward/{name}/group_std_mean"] = float(g_stds.mean())
            metrics[f"reward/{name}/group_std_max"] = float(g_stds.max())
            metrics[f"reward/{name}/group_std_min"] = float(g_stds.min())
            metrics[f"reward/{name}/group_mean_std"] = float(g_means.std())
            metrics[f"reward/{name}/zero_std_group_ratio"] = float((g_stds < _EPS).mean())
        return metrics
