"""Reward post-processing helpers (the port's copy of
``flow_factory_tpu/utils/reward_utils.py``, numpy on the host).

Grid/pairwise utilities used by groupwise rewards and analysis: pairwise
win-rate matrices, Bradley-Terry strength estimates, rank normalization.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pairwise_matrix(scores: Sequence[float]) -> np.ndarray:
    """(K, K) matrix M[i, j] = 1 if score_i > score_j, 0.5 ties."""
    s = np.asarray(scores, np.float64)
    gt = (s[:, None] > s[None, :]).astype(np.float64)
    eq = (s[:, None] == s[None, :]).astype(np.float64)
    return gt + 0.5 * eq - 0.5 * np.eye(len(s))


def win_rates(scores: Sequence[float]) -> np.ndarray:
    """Per-sample mean pairwise win rate in [0, 1]."""
    m = pairwise_matrix(scores)
    k = len(scores)
    if k <= 1:
        return np.ones(k)
    return m.sum(axis=1) / (k - 1)


def bradley_terry(pair_wins: np.ndarray, iters: int = 50) -> np.ndarray:
    """BT strengths from a pairwise win-count matrix (minorization updates)."""
    k = pair_wins.shape[0]
    p = np.ones(k, np.float64)
    games = pair_wins + pair_wins.T
    wins = pair_wins.sum(axis=1)
    for _ in range(iters):
        denom = (games / np.maximum(p[:, None] + p[None, :], 1e-12)).sum(axis=1)
        p_new = np.where(denom > 0, wins / np.maximum(denom, 1e-12), p)
        p = p_new / max(p_new.sum(), 1e-12) * k
    return p


def rank_normalize(scores: Sequence[float]) -> np.ndarray:
    """Ranks mapped to [0, 1] (groupwise rank rewards)."""
    s = np.asarray(scores, np.float64)
    if len(s) <= 1:
        return np.ones_like(s)
    order = np.argsort(np.argsort(s))
    return order / (len(s) - 1)
